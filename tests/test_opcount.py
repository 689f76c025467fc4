"""The device-independent op counter of the kernel bodies
(utils/opcount.py)."""
from ray_tracer_fragment_shader_tpu.scene import presets
from ray_tracer_fragment_shader_tpu.utils.opcount import (kernel_live_planes,
                                                          kernel_op_counts)


def test_live_plane_analysis():
    """The jaxpr max-live analyzer produces sane plane counts: positive,
    and the backward's working set larger than the forward's (it holds
    per-level records + cotangent accumulators)."""
    scene, _, cfg = presets.full_reflective(size=32, depth=2)
    fwd_live, bwd_live = kernel_live_planes(scene, cfg)
    assert 10 < fwd_live < 1000
    assert bwd_live > fwd_live
    # counts and live numbers come from the same cached trace
    fwd, bwd = kernel_op_counts(scene, cfg)
    assert sum(fwd.values()) > sum(bwd.values()) > 0
    assert not any(k.startswith("other:") for k in {**fwd, **bwd})
