"""ray_tracer_fragment_shader_tpu — a differentiable ray tracer in JAX/Pallas.

A from-scratch JAX/Pallas framework with the capabilities of the reference
C++/SDL ray tracer (D4rkFr4g/Ray_Tracer_Fragment_Shader): see SURVEY.md for
the capability inventory and BASELINE.md for performance targets.
"""
from .config import CameraConfig, RenderConfig
from .core.renderer import render_image, render_image_jit, render_pixels, render_rays
from .ops.rays import Camera
from .scene import (FlatScene, Material, SceneBuilder, PRESETS,
                    convert_board_coordinate)

__version__ = "0.1.0"

__all__ = [
    "CameraConfig", "RenderConfig", "Camera", "FlatScene", "Material",
    "SceneBuilder", "PRESETS", "convert_board_coordinate",
    "render_image", "render_image_jit", "render_pixels", "render_rays",
]
