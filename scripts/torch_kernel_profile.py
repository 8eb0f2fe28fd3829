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
the wrapper's weight packing included) beside ``query_field``.

K1's and K2's device time, the median of three windows, is printed beside
the device times of the compare-and-count
design they replaced, on the same card model (``COMPARE_COUNT_DEVICE_MS``),
their bound, and the device time of one copy that moves the same bytes
(what one launch moving that much takes on the card, called back to back as
here, where the rows stay in the 50 MB L2), and then the host's cost per
call, ``perf_counter_ns`` around 1,000 calls with no synchronisation (3
turns, median), of the wrapper (through its registered operator, whose CUDA
implementation launches the plain-C library through ctypes) and of
``torch.searchsorted`` on the same CDF rows and queries, in turns under one
``inference_mode`` block, as the renderers call them.

The first line is the card's name and power limit; then the three libraries'
paths, ptxas's report for K3 (registers, spills) and the dynamic shared
memory a block of it takes.
Exits 1 without a card, or when the profiler sees no device time.
"""
from __future__ import annotations

import concurrent.futures
import os
import statistics
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity

CALLS = 5
HOST_CALLS = 1000
# Device ms per call at these shapes of the compare-and-count design that the
# binary search replaced (PERF.md, NVIDIA H100 80GB HBM3 at 700 W).
COMPARE_COUNT_DEVICE_MS = {"K1": 0.0105, "K2": 0.0099}


def device_ms(fn, calls: int = CALLS, attempts: int = 3) -> tuple[float, dict]:
    """Device milliseconds per call, and {kernel name: (count, us)}, read by
    ``train/profiling.py:profile_rows``. A profiler window that records no
    device activity at all is taken again (up to ``attempts`` windows)."""
    from scnerf_tpu_torch.train.profiling import profile_rows, roofline_summary, trace

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with trace(None, activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   with_flops=False) as prof:
            for _ in range(calls):
                fn()
        cols, rows = profile_rows(prof)
        kernels = {r[0]: (r[2], r[3]) for r in rows if r[1] == "cuda" and r[3] > 0}
        if kernels:
            return roofline_summary(cols, rows, calls)["device_us_per_step"] / 1e3, kernels
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
    from chip_smoke import HBM_BYTES_PER_S, in_turns
    from scnerf_tpu_torch.fields.nerf import NeRFConfig, init_nerf_mlp, query_field
    from scnerf_tpu_torch.kernels import _build, mlp_cuda, pdf_cuda, searchsorted_cuda
    from scnerf_tpu_torch.sampling.pdf import inverse_cdf, pdf_uniforms, sample_pdf
    from scnerf_tpu_torch.sampling.searchsorted import searchsorted
    from scnerf_tpu_torch.serve import fp32_inference

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    cfg = NeRFConfig()
    sources = ("sample_pdf", "fused_mlp", "searchsorted")  # K1 and K2, K3, K4
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each
        for name, lib in zip(sources, pool.map(_build.build, sources)):
            print(f"{name}: {lib}")
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
            variant = "nerf" if label == "K1" else "nerfpp"
            # Reads bins, weights and u, writes the depths (K2 also the counts).
            n_bytes = 4 * (n * b + n * (b - 1) + (2 if label == "K1" else 3) * n * s)
            bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            if label == "K1":
                kernel = lambda: pdf_cuda.sample_pdf_core(bins, weights, u)  # noqa: E731
                ms = report(f"K1 sample_pdf_core ({n},{b},{s})", kernel)
                report("    plain twin", lambda: pdf_cuda.sample_pdf_plain(bins, weights, u))
            else:
                kernel = lambda: pdf_cuda.sample_pdf_diff(bins, weights, u, "nerfpp")  # noqa: E731
                ms = report(f"K2 sample_pdf_diff nerfpp ({n},{b},{s})", kernel)
                report("    plain twin",
                       lambda: sample_pdf(None, bins, weights, s, u=u, variant="nerfpp"))
            # What the card takes to move the same bytes in one launch: a
            # copy that reads half of them and writes the other half.
            src = torch.empty(n_bytes // 8, dtype=torch.float32, device=dev)
            dst = torch.empty_like(src)
            copy_ms = report("    copy of the same bytes", lambda: dst.copy_(src))
            # The median of three windows, the first the one reported above.
            ms = statistics.median([ms, device_ms(kernel)[0], device_ms(kernel)[0]])
            before = COMPARE_COUNT_DEVICE_MS[label]
            print(f"    {label}: {ms:.6f} ms device (median of 3 windows) against compare-and-count's {before} ms "
                  f"({before / ms:.2f}x); bound {bound_ms:.6f} ms (bytes), "
                  f"{bound_ms / ms:.1%} of it; the copy {copy_ms:.6f} ms, "
                  f"{copy_ms / ms:.1%} of the kernel's time")

            cdf = inverse_cdf(bins, weights, u, variant)[2]
            searched = cdf[:, :-1].contiguous() if label == "K2" else cdf
            with torch.inference_mode():
                host = in_turns({
                    "the wrapper (operator)": kernel,
                    "torch.searchsorted": lambda: torch.searchsorted(
                        searched, u, right=True, out_int32=True),
                }, HOST_CALLS, 3, host_only=True)
            print(f"    {label} host-only ms per call: "
                  + ", ".join(f"{k} {v:.5f}" for k, v in host.items()))

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
