"""Model FLOPs and kernel bytes, counted from shapes.

FLOPs count the matmuls of every MLP evaluation a step or a request asks
for (two FLOPs a multiply-add), forward and, for training, backward (the
gradients of the inputs and of the weights: twice the forward), and no
recompute. Kernel bytes count each input read once and each output the
caller needs written once, at the call's shapes, whatever implements it.
"""
from __future__ import annotations

FLOAT = 4
INT32 = 4


def positional_dim(input_dim: int, n_freqs: int) -> int:
    """Width of the positional encoding: the input and a sine and cosine a
    frequency a coordinate."""
    return input_dim * (1 + 2 * n_freqs)


def nerf_point_macs(depth: int, width: int, skips, pos_dim: int, view_dim: int,
                    use_viewdirs: bool = True, output_ch: int = 4) -> int:
    """Multiply-adds of one point through the NeRF MLP
    (``fields/nerf.py``): the trunk, whose layer after each skip also takes
    the encoded position, and the viewdirs head."""
    macs, in_dim = 0, pos_dim
    for i in range(depth):
        macs += in_dim * width
        in_dim = width + pos_dim if i in skips else width
    if use_viewdirs:
        macs += width * width + width * 1 + (width + view_dim) * (width // 2) + (width // 2) * 3
    else:
        macs += width * output_ch
    return macs


def mlpnet_point_macs(depth: int, width: int, skips, pos_dim: int, view_dim: int) -> int:
    """Multiply-adds of one point through a NeRF++ MLPNet
    (``fields/nerfpp.py``): the base, sigma, remap (256) and the two rgb
    layers."""
    macs, in_dim = 0, pos_dim
    for i in range(depth):
        macs += in_dim * width
        in_dim = width + pos_dim if (i in skips and i != depth - 1) else width
    return macs + in_dim * 1 + in_dim * 256 + (256 + view_dim) * (width // 2) + (width // 2) * 3


def nerf_ray_forward_flops(flags: dict) -> int:
    """Forward FLOPs of one ray of the NeRF cascade: ``N_samples`` coarse and
    ``N_samples + N_importance`` fine points."""
    macs = nerf_point_macs(flags["netdepth"], flags["netwidth"], (4,),
                           positional_dim(3, flags["multires"]),
                           positional_dim(3, flags["multires_views"]), flags["use_viewdirs"])
    points = flags["N_samples"] + (flags["N_samples"] + flags["N_importance"]
                                   if flags["N_importance"] > 0 else 0)
    return 2 * macs * points


def nerfpp_ray_forward_flops(flags: dict) -> int:
    """Forward FLOPs of one ray of the NeRF++ cascade: at each level, the fg
    net on its points and the bg net on as many (level ``m`` holds the
    samples of levels ``0..m``)."""
    depth, width = flags["netdepth"], flags["netwidth"]
    view = positional_dim(3, flags["max_freq_log2_viewdirs"])
    fg = mlpnet_point_macs(depth, width, (4,), positional_dim(3, flags["max_freq_log2"]), view)
    bg = mlpnet_point_macs(depth, width, (4,), positional_dim(4, flags["max_freq_log2"]), view)
    samples = list(flags["cascade_samples"])[:flags["cascade_level"]]
    points = sum(sum(samples[:m + 1]) for m in range(len(samples)))
    return 2 * (fg + bg) * points


def train_flops_per_step(ray_forward_flops: int, n_rand: int) -> int:
    """A train step's FLOPs: forward and backward (three times the forward)
    of every ray of the batch."""
    return 3 * ray_forward_flops * n_rand


def resample_bytes(n_rays: int, n_depths: int, n_samples: int, *, with_inds: bool = False,
                   with_cdf: bool = False) -> int:
    """Bytes of one inverse-CDF resample of ``n_rays`` rays over the
    midpoints of ``n_depths`` depths: reads the ``n_depths - 1`` bins, the
    ``n_depths - 2`` inner weights and ``n_samples`` uniforms a ray; writes
    ``n_samples`` depths, and the search counts and the CDF where the caller
    keeps them for a backward."""
    bins, weights = n_depths - 1, n_depths - 2
    read = FLOAT * n_rays * (bins + weights + n_samples)
    written = FLOAT * n_rays * n_samples
    if with_inds:
        written += INT32 * n_rays * n_samples
    if with_cdf:
        written += FLOAT * n_rays * bins
    return read + written
