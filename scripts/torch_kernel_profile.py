"""Device time of the PyTorch port's CUDA kernels, by ``torch.profiler``.

    python3 scripts/torch_kernel_profile.py

Needs one NVIDIA card and the CUDA toolkit; imports no JAX. For each of K1-K4
at the serving paths' shapes, and for the PyTorch code each is compared with
(the plain twin, and the one library call where there is one), it profiles
a few back-to-back calls after a warm-up and prints the device time per
call: the summed duration of every kernel the call ran, so the host's work
between launches is left out (CUDA events around a call include it). The
inputs are seeded random data of the serving shapes: K1 (8192 rays, 63
bins, 64 deterministic samples), K2 (4096, 63, 128) as the NeRF++ renderer
calls it, and its plain twin, K4 (8192 rows of 63 with 64 queries and 4096
of 63 with 128, right side) beside its twin and ``torch.searchsorted``, K3
(8192 rays x 64 and x 128 points of the NeRF 8x256 MLP at multires 10/4,
the wrapper's weight packing included) beside ``query_field``. The first
line is the card's name and power limit; then ptxas's report for K3
(registers, spills) and the dynamic shared memory a block of it takes.
Exits 1 without a card, or when the profiler sees no device time.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

CALLS = 5


def device_ms(fn, calls: int = CALLS, attempts: int = 3) -> tuple[float, dict]:
    """Device milliseconds per call, and {kernel name: (count, us)}. A
    profiler window that records no device activity at all is taken again
    (up to ``attempts`` windows)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0}
        total_us = sum(us for _, us in kernels.values())
        if total_us > 0:
            return total_us / calls / 1e3, kernels
    raise SystemExit("torch_kernel_profile: the profiler saw no device time")


def report(name: str, fn, calls: int = CALLS) -> float:
    ms, kernels = device_ms(fn, calls)
    print(f"{name}: {ms:.6f} ms device per call ({calls} calls)")
    for key, (count, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"    {us / calls / 1e3:.6f} ms/call  x{count / calls:g}  {key[:100]}")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp, query_field
    from scnerf_tpu_torch.kernels import _build, mlp_cuda, pdf_cuda, searchsorted_cuda
    from scnerf_tpu_torch.sampling.pdf import pdf_uniforms, sample_pdf
    from scnerf_tpu_torch.sampling.searchsorted import searchsorted
    from scnerf_tpu_torch.serve import fp32_inference

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    cfg = NeRFConfig()
    _build.load("fused_mlp")
    print("K3 ptxas report (-Xptxas -v):")
    for line in (_build.BUILD_DIR / "fused_mlp.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())
    print(f"K3 dynamic shared memory per block at multires {cfg.multires}/{cfg.multires_views}: "
          f"{mlp_cuda.shared_memory_bytes(cfg)} bytes")

    def rows(n, b):
        return torch.from_numpy(np.sort(rng.random((n, b)), -1).astype(np.float32)).to(dev)

    with fp32_inference():
        for label, n, b, s in (("K1", 8192, 63, 64), ("K2", 4096, 63, 128)):
            bins = rows(n, b) * 4 + 2
            weights = torch.from_numpy(rng.random((n, b - 1)).astype(np.float32)).to(dev)
            u = pdf_uniforms(None, n, s, True, device=dev)
            if label == "K1":
                report(f"K1 sample_pdf_core ({n},{b},{s})",
                       lambda: pdf_cuda.sample_pdf_core(bins, weights, u))
                report("    plain twin", lambda: pdf_cuda.sample_pdf_plain(bins, weights, u))
            else:
                report(f"K2 sample_pdf_diff nerfpp ({n},{b},{s})",
                       lambda: pdf_cuda.sample_pdf_diff(bins, weights, u, "nerfpp"))
                report("    plain twin",
                       lambda: sample_pdf(None, bins, weights, s, u=u, variant="nerfpp"))

        for n, b, m in ((8192, 63, 64), (4096, 63, 128)):
            a = rows(n, b)
            v = torch.from_numpy(rng.random((n, m)).astype(np.float32)).to(dev)
            report(f"K4 searchsorted_cuda ({n},{b})/({n},{m}) right",
                   lambda: searchsorted_cuda.searchsorted_cuda(a, v, "right"))
            report("    plain twin", lambda: searchsorted(a, v, "right"))
            report("    torch.searchsorted",
                   lambda: torch.searchsorted(a, v, side="right", out_int32=True))

        params = init_nerf_mlp(cfg, generator=torch.Generator().manual_seed(0), device=dev)
        vd = torch.nn.functional.normalize(torch.randn(8192, 3, device=dev), dim=-1)
        for s in (64, 128):
            pts = torch.rand(8192, s, 3, device=dev) * 2 - 1
            report(f"K3 fused_query_field (8192,{s})",
                   lambda: mlp_cuda.fused_query_field(params, cfg, pts, vd), calls=3)
            report("    query_field (the twin's body)",
                   lambda: query_field(params, cfg, pts, vd), calls=3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
