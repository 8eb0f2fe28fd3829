"""The FLOP and byte counters against hand counts and against PyTorch's
own count of the port's fields at small shapes."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.drivers.train_nerfpp import k2_bytes_per_step
from portbench.metrics import counts
from portbench.tests.tiny import load


def test_nerf_point_macs_by_hand():
    # depth 2, width 4, encoded position 9, view 6: 9x4 + 4x4 trunk,
    # feature 4x4, alpha 4x1, views (4+6)x2, rgb 2x3.
    assert counts.nerf_point_macs(2, 4, (4,), 9, 6) == 36 + 16 + 16 + 4 + 20 + 6
    # the skip after layer 0 widens layer 1 by the encoded position
    assert counts.nerf_point_macs(2, 4, (0,), 9, 6) == 36 + 13 * 4 + 16 + 4 + 20 + 6


def test_fern_step_matches_the_derived_count():
    flags = {**load("configs", "fern_ours")["published"], **load("configs", "fern_ours")["defaults"]}
    assert counts.nerf_point_macs(8, 256, (4,), 63, 27) == 593408
    step = counts.train_flops_per_step(counts.nerf_ray_forward_flops(flags), 1024)
    assert abs(step / 7.0011e11 - 1.0) < 1e-3  # the profiler-derived count of a fern step


def test_truck_ray_flops_by_hand():
    c = load("configs", "tat_training_Truck_ours")
    flags = {**c["published"], **c["defaults"]}
    fg = counts.mlpnet_point_macs(8, 256, (4,), 63, 27)
    bg = counts.mlpnet_point_macs(8, 256, (4,), 84, 27)
    assert (fg, bg) == (593408, 604160)
    assert counts.nerfpp_ray_forward_flops(flags) == 2 * (fg + bg) * (64 + 64 + 128)


def count_flops(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def test_nerf_forward_and_backward_against_pytorch_counts():
    from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp, query_field

    cfg = NeRFConfig(depth=3, width=8, multires=2, multires_views=1)
    params = init_nerf_mlp(cfg, device="cpu")
    pts = torch.rand(5, 7, 3, requires_grad=True)
    dirs = torch.rand(5, 3)
    macs = counts.nerf_point_macs(3, 8, (4,), counts.positional_dim(3, 2),
                                  counts.positional_dim(3, 1))
    assert count_flops(lambda: query_field(params, cfg, pts, dirs)) == 2 * macs * 35
    for layer in params.values():
        for x in (layer if isinstance(layer, list) else [layer]):
            x["w"].requires_grad_(True)
    both = count_flops(lambda: query_field(params, cfg, pts, dirs).sum().backward())
    assert both == 3 * 2 * macs * 35


def test_nerfpp_mlpnet_against_pytorch_counts():
    from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig, init_mlpnet, query_mlpnet

    cfg = NerfPPConfig(depth=6, width=8, max_freq_log2=2, max_freq_log2_viewdirs=1)
    for dim in (3, 4):
        params = init_mlpnet(cfg, dim, device="cpu")
        pts = torch.rand(4, 6, dim)
        views = torch.rand(4, counts.positional_dim(3, 1))
        macs = counts.mlpnet_point_macs(6, 8, (4,), counts.positional_dim(dim, 2),
                                        counts.positional_dim(3, 1))
        assert count_flops(lambda: query_mlpnet(params, cfg, pts, views, dim)) == 2 * macs * 24


def test_resample_bytes_by_hand():
    # 2 rays, 5 depths: 4 bins, 3 weights, 6 uniforms read; 6 depths written
    assert counts.resample_bytes(2, 5, 6) == 4 * 2 * (4 + 3 + 6) + 4 * 2 * 6
    assert counts.resample_bytes(2, 5, 6, with_inds=True, with_cdf=True) == (
        4 * 2 * (4 + 3 + 6) + 4 * 2 * 6 + 4 * 2 * 6 + 4 * 2 * 4)
    assert counts.resample_bytes(8192, 64, 64) == 8192 * (63 + 62 + 64 + 64) * 4


def test_k2_bytes_per_step_by_hand():
    flags = {"N_rand": 2, "cascade_samples": [5, 6, 7], "cascade_level": 3}
    fg1 = counts.resample_bytes(2, 5, 6, with_inds=True, with_cdf=True)
    fg2 = counts.resample_bytes(2, 11, 7, with_inds=True, with_cdf=True)
    assert k2_bytes_per_step(flags) == (fg1 + counts.resample_bytes(2, 5, 6)
                                        + fg2 + counts.resample_bytes(2, 11, 7))
