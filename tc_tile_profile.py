#!/usr/bin/env python3
"""Where the time of K1-K4 goes inside their shared tensor-core tile.

    python3 tc_tile_profile.py        # from the root of a checkout, one NVIDIA GPU

Builds measurement copies of ``streamz_tpu_torch/csrc/mfcc_tc.cuh`` with the
entry sources of K1 (``mfcc_base.cu``), K2 (``mfcc_v3.cu``), K3
(``mfcc_v2.cu``) and K4 (``mfcc_frames.cu``) into a temporary directory (the
package's own build is untouched), runs each at the main path's
[64, 819200], and prints:

- ``clocks``: the tile with ``clock64()`` marks on the consumer warpgroup's
  first thread of every CTA, summed over the CTAs: the wait for a tile's
  PCM planes, the DFT products (ring waits included), the combine and
  power (K4: the power alone), the mel stage, and the hand-off of the log
  mel energies, each as a share of the CTA's cycles from its first to its
  last instruction.  The marks cost a few percent of the kernel's time,
  printed beside it.
- ``cluster1``: the tile with clusters of one CTA (``kCluster = 1``), so
  every CTA reads each basis stage from L2 itself instead of sharing one
  multicast read with its neighbour; the kernel time beside the shipped
  tile's.
- ``cluster4`` (K4 only): K4 with clusters of four CTAs, so one L2 read of
  each stage serves four tiles; beside the shipped clusters of two.

Every copy is held against its kernel's plain version within 1e-3.
Numbers also go to ``chiprun_out/tc_tile_profile.json``.  Exits non-zero
without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CSRC = HERE / "streamz_tpu_torch" / "csrc"
SHAPE = (64, 819200)
PHASES = ("wait for the planes", "DFT products", "combine and power", "mel stage",
          "log mel hand-off")

# (anchor, replacement) edits of mfcc_tc.cuh for the clock marks.  Each
# anchor must occur exactly once.
CLOCKS = [
    ("namespace streamz_tc {\n",
     "namespace streamz_tc {\n__device__ unsigned long long g_clocks[8];\n"
     "#define MARK long long _t0 = clock64();\n"
     "#define ADD(i) if (threadIdx.x == 0) atomicAdd(&g_clocks[i], "
     "(unsigned long long)(clock64() - _t0));\n"),
    ("    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;\n",
     "    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;\n"
     "    const long long _start = clock64();\n"),
    ("      mbar_wait(&s.a_full, k & 1);  // the tile's planes are written\n",
     "      { MARK mbar_wait(&s.a_full, k & 1); ADD(0) }\n"),
    ("        for (int it = 0; it < T::kDftItems; ++it, ++n) {",
     "        { MARK\n        for (int it = 0; it < T::kDftItems; ++it, ++n) {"),
    ("        release(s, prev, lane);\n        if (last) mbar_arrive(&s.a_free",
     "        release(s, prev, lane);\n        ADD(1) }\n        MARK\n"
     "        if (last) mbar_arrive(&s.a_free"),
    ("        if constexpr (T::kMelTc) {\n          // The strip's mel planes",
     "        ADD(2)\n        { MARK\n        if constexpr (T::kMelTc) {\n"
     "          // The strip's mel planes"),
    ("          consumers_sync();  // the next strip overwrites the power\n        }\n      }\n",
     "          consumers_sync();  // the next strip overwrites the power\n        }\n"
     "        ADD(3) }\n      }\n      MARK\n"),
    ("      mbar_arrive(&s.ml_full);\n",
     "      mbar_arrive(&s.ml_full);\n      ADD(4)\n"),
    ("      mbar_arrive(&s.ml_full);\n      ADD(4)\n    }\n",
     "      mbar_arrive(&s.ml_full);\n      ADD(4)\n    }\n"
     "    if (tid == 0) atomicAdd(&g_clocks[7], (unsigned long long)(clock64() - _start));\n"),
]
CLUSTER1 = [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")]
CLUSTER4 = [("constexpr int kCluster = 2;", "constexpr int kCluster = 4;")]  # built for K4 only
KERNELS = (("mfcc_base", "K1"), ("mfcc_v3", "K2"), ("mfcc_v2", "K3"), ("mfcc_frames", "K4"))
READ_CLOCKS = """
extern "C" void streamz_read_clocks(unsigned long long* h) {
  cudaMemcpyFromSymbol(h, streamz_tc::g_clocks, sizeof(unsigned long long) * 8);
}
extern "C" void streamz_zero_clocks() {
  unsigned long long z[8] = {};
  cudaMemcpyToSymbol(streamz_tc::g_clocks, z, sizeof(z));
}
"""


def fail(msg: str) -> None:
    print(f"tc_tile_profile: {msg}", file=sys.stderr)
    sys.exit(1)


def edited(edits) -> str:
    text = (CSRC / "mfcc_tc.cuh").read_text()
    for anchor, new in edits:
        if text.count(anchor) != 1:
            fail(f"anchor not found once in mfcc_tc.cuh: {anchor!r}")
        text = text.replace(anchor, new)
    return text


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available; this measurement needs an NVIDIA GPU")
    if not (CSRC / "mfcc_tc.cuh").exists():
        fail(f"run from a checkout of the repository ({CSRC} missing)")
    sys.path.insert(0, str(HERE))
    from streamz_tpu_torch import _cuda_build, bench
    from streamz_tpu_torch.dsp import mfcc_kernel as mk
    from streamz_tpu_torch.runtime.measure import chain_timer

    card = bench.card_line()
    work = Path(tempfile.mkdtemp(prefix="streamz_tc_profile_"))
    variants = {"shipped": [], "clocks": CLOCKS, "cluster1": CLUSTER1, "cluster4": CLUSTER4}
    procs = {}
    for name, edits in variants.items():
        d = work / name
        d.mkdir()
        (d / "mfcc_tc.cuh").write_text(edited(edits))
        (d / "hopper.cuh").write_text((CSRC / "hopper.cuh").read_text())
        for src, _ in KERNELS:
            if name == "cluster4" and src != "mfcc_frames":
                continue
            body = (CSRC / f"{src}.cu").read_text()
            (d / f"{src}.cu").write_text(body + (READ_CLOCKS if name == "clocks" else ""))
            cmd = [_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS, f"-I{d}", "-o",
                   str(d / f"lib{src}.so"), str(d / f"{src}.cu")]
            procs[(name, src)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            fail(f"nvcc failed for {key}:\n{log[-3000:]}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pcm = torch.randn(SHAPE, generator=gen, device=dev) * 0.1
    out = torch.empty((SHAPE[0], SHAPE[1] // 400 - 1, 20), device=dev)
    report = {"card": card, "shape": list(SHAPE)}
    print(f"device: {torch.cuda.get_device_name(0)} | {card}")
    plain = {"K1": lambda x: mk.mfcc_base_bf16x3_plain(x, True, tail_fold=True),
             "K2": lambda x: mk.mfcc_base_bf16x3_plain(x, True),
             "K3": lambda x: mk.mfcc_base_bf16x3_plain(x, False),
             "K4": mk.mfcc_base_frames_plain}
    for src, kid in KERNELS:
        want = plain[kid](pcm)
        consts = mk._device_constants(dev, src)
        entry, n_consts = mk._ENTRIES[src]
        times = {}
        for name in variants:
            if not (work / name / f"lib{src}.so").exists():
                continue
            lib = ctypes.CDLL(str(work / name / f"lib{src}.so"))
            fn = getattr(lib, entry)
            p, i64 = ctypes.c_void_p, ctypes.c_longlong
            fn.argtypes = [p, i64, i64, *([p] * n_consts), p, p]
            fn.restype = ctypes.c_int

            def call():
                rc = fn(pcm.data_ptr(), SHAPE[0], SHAPE[1], *(c.data_ptr() for c in consts),
                        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    fail(f"{kid} {name}: launch failed, CUDA error {rc}")

            if name == "clocks":
                lib.streamz_zero_clocks()
            call()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if err > 1e-3:
                fail(f"{kid} {name} disagrees with its plain version: {err:.3e}")
            if name == "clocks":
                clocks = (ctypes.c_ulonglong * 8)()
                lib.streamz_read_clocks(clocks)
            times[name] = min(chain_timer(call, iters=20, repeats=1) * 1e3 for _ in range(2))
        total = clocks[7]
        shares = {ph: clocks[i] / total for i, ph in enumerate(PHASES)}
        shares["the rest (loop, setup)"] = 1.0 - sum(shares.values())
        report[kid] = {"ms": times["shipped"], "clocks_ms": times["clocks"],
                       "cluster1_ms": times["cluster1"], "shares": shares}
        four = ""
        if "cluster4" in times:
            report[kid]["cluster4_ms"] = times["cluster4"]
            four = f"; with clusters of four {times['cluster4']:.4f} ms"
        print(f"[{kid}] [{SHAPE[0]}, {SHAPE[1]}]: {times['shipped']:.4f} ms; with the clock "
              f"marks {times['clocks']:.4f} ms; with clusters of one CTA (no multicast) "
              f"{times['cluster1']:.4f} ms{four} | {card}")
        print(f"[{kid}] the consumers' cycles, summed over the CTAs: " + ", ".join(
            f"{ph} {v:.1%}" for ph, v in shares.items()) + f" | {card}")
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "tc_tile_profile.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
