#!/usr/bin/env python3
"""Where the time of K7 goes: its design choices measured one at a time.

    python3 k7_profile.py        # from the root of a checkout, one NVIDIA GPU

Builds measurement copies of ``streamz_tpu_torch/csrc/forward_probs.cu``,
each with one design choice changed, into a temporary directory (the
package's own build is untouched), one ``nvcc`` each, all at once:

- ``shipped``: the source as it is;
- ``nofence``: without the fences (an empty ``asm`` naming the
  accumulator's registers) before each stage's ``wgmma`` and after its
  commit;
- ``steps2``: ring stages of two k16 steps (8 KB), four of them (the same
  bytes);
- ``cluster1``: clusters of one CTA, so each CTA reads every weight stage
  from L2 itself (no multicast);
- ``xbatch1``: each thread's x loads one unit at a time;
- ``clocks``: the shipped design with ``clock64()`` marks on each consumer
  warpgroup's first thread and on the producers, summed over the CTAs:
  the x load, each layer's products and epilogues, the softmax and stores,
  and inside the products the waits for a full stage, the ``wgmma`` issues,
  the waits for the products and the stage releases; the producers' waits
  for a free stage.  Printed as shares of the consumers' (the producers')
  cycles; the marks' own cost shows in the copy's time.

Each copy is held against the plain version within 2e-4 on every window
of inputs whose sums are exact in any order (``chip_smoke.k7_exact_inputs``)
and timed at the identify batch's shape (70,464 windows, 60 → 512 → 256 →
128, 8 live classes): its C entry (the pack kernel and the forward) on
buffers made once, CUDA events over 50 launches, the better of two runs,
the variants in turn and the shipped one again at the end.  For each copy
it prints ``ptxas``'s registers and spills and counts its notes that
``wgmma`` was serialized (C7514) or that waits or arrives were injected
(C7517, C7519).  Beside them: the pack kernel alone and the three products
alone as bf16 ``torch.matmul``.
Numbers also go to ``chiprun_out/k7_profile.json``.  Exits non-zero without
CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CSRC = HERE / "streamz_tpu_torch" / "csrc"
R, DIMS, NS = 70464, (60, 512, 256, 128), 8
TOL = 2e-4

# (anchor, replacement) edits of forward_probs.cu; each anchor occurs once.
VARIANTS = {
    "shipped": [],
    "nofence": [("    mbar_wait(&s.full[st], (n / kStages) & 1);\n    fence_regs<64>(acc);\n",
                 "    mbar_wait(&s.full[st], (n / kStages) & 1);\n"),
                ("    wgmma_commit();\n    fence_regs<64>(acc);\n    wgmma_wait<0>();\n",
                 "    wgmma_commit();\n    wgmma_wait<0>();\n")],
    "steps2": [("constexpr int kStageSteps = 4;", "constexpr int kStageSteps = 2;"),
               ("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "cluster1": [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")],
    "xbatch1": [("constexpr int kXBatch = 4;", "constexpr int kXBatch = 1;")],
}
# The shipped design with clock64() marks, summed over every consumer
# warpgroup's first thread (0-9, 12, 13) and every producer (10, 11).
PHASES = ("x load", "layer 1 products", "layer 1 epilogues", "layer 2 products",
          "layer 2 epilogues", "layer 3 products", "softmax and stores",
          "ring waits (in the products)", "consumer total",
          "wgmma waits (in the products)", "producer: waits for a free stage",
          "producer total", "stage releases (in the products)",
          "wgmma issues (in the products)")
MARK_ADD = ("#define MARK long long _t0 = clock64();\n"
            "#define ADD(i) if ((threadIdx.x & 127) == 0) atomicAdd(&g_clocks[i], "
            "(unsigned long long)(clock64() - _t0));\n")
CLOCKS = [
    ("namespace {\n\nusing namespace streamz_hopper;\n",
     "namespace {\n\nusing namespace streamz_hopper;\n"
     "__device__ unsigned long long g_clocks[16];\n" + MARK_ADD),
    ("    mbar_wait(&s.full[st], (n / kStages) & 1);\n    fence_regs<64>(acc);\n",
     "    { MARK mbar_wait(&s.full[st], (n / kStages) & 1); ADD(7) }\n"
     "    { MARK fence_regs<64>(acc);\n"),
    ("    wgmma_commit();\n    fence_regs<64>(acc);\n    wgmma_wait<0>();\n",
     "    wgmma_commit(); ADD(13) }\n    fence_regs<64>(acc);\n"
     "    { MARK wgmma_wait<0>(); ADD(9) }\n"),
    ("    if (lane < kCluster) mbar_arrive_cluster(&s.empty[st], lane);\n  }\n}",
     "    { MARK if (lane < kCluster) mbar_arrive_cluster(&s.empty[st], lane); ADD(12) }\n"
     "  }\n}"),
    ("    uint32_t n = 0;\n    float acc[64];\n",
     "    uint32_t n = 0;\n    float acc[64];\n    const long long _start = clock64();\n"),
    ("      group_sync(wg);  // the previous tile's last reads of h2 are done\n"
     "      load_x(p, row0, t, xh2);\n      fence_proxy_async_shared();\n      group_sync(wg);\n",
     "      { MARK group_sync(wg);\n      load_x(p, row0, t, xh2);\n"
     "      fence_proxy_async_shared();\n      group_sync(wg); ADD(0) }\n"),
    ("        chunk_product<kOnChip>(acc, xh2, d.K1, s, n, lane);\n"
     "        chunk_to_tile<kRelu>(acc, p.b1, d.H1, c, h1, warp, lane);\n",
     "        { MARK chunk_product<kOnChip>(acc, xh2, d.K1, s, n, lane); ADD(1) }\n"
     "        { MARK chunk_to_tile<kRelu>(acc, p.b1, d.H1, c, h1, warp, lane); ADD(2) }\n"),
    ("        chunk_product<kOnChip>(acc, h1, d.N1, s, n, lane);\n"
     "        chunk_to_tile<kTanh>(acc, p.b2, d.H2, c, xh2, warp, lane);\n",
     "        { MARK chunk_product<kOnChip>(acc, h1, d.N1, s, n, lane); ADD(3) }\n"
     "        { MARK chunk_to_tile<kTanh>(acc, p.b2, d.H2, c, xh2, warp, lane); ADD(4) }\n"),
    ("          chunk_product<kOnChip>(acc, xh2, d.N2, s, n, lane);\n",
     "          { MARK chunk_product<kOnChip>(acc, xh2, d.N2, s, n, lane); ADD(5) }\n"
     "          MARK\n"),
    ("            write_probs(acc, true, m, se, p, row0, c, warp, lane);\n          }\n"
     "        }\n      }\n    }\n",
     "            write_probs(acc, true, m, se, p, row0, c, warp, lane);\n          }\n"
     "          ADD(6)\n        }\n      }\n    }\n"
     "    if (t == 0) atomicAdd(&g_clocks[8], (unsigned long long)(clock64() - _start));\n"),
    ("      uint32_t n = 0;\n      for (int grp = cluster; grp < p.groups; grp += clusters) {\n",
     "      uint32_t n = 0;\n      const long long _ps = clock64();\n"
     "      for (int grp = cluster; grp < p.groups; grp += clusters) {\n"),
    ("              mbar_wait(&s.empty[st], ((n / kStages) & 1) ^ 1);\n",
     "              { const long long _p = clock64();\n"
     "              mbar_wait(&s.empty[st], ((n / kStages) & 1) ^ 1);\n"
     "              atomicAdd(&g_clocks[10], (unsigned long long)(clock64() - _p)); }\n"),
    ("      }\n    }\n    __syncwarp();\n",
     "      }\n      atomicAdd(&g_clocks[11], (unsigned long long)(clock64() - _ps));\n"
     "    }\n    __syncwarp();\n"),
]
READ_CLOCKS = """
extern "C" void streamz_read_clocks(unsigned long long* h) {
  cudaMemcpyFromSymbol(h, g_clocks, sizeof(unsigned long long) * 16);
}
extern "C" void streamz_zero_clocks() {
  unsigned long long z[16] = {};
  cudaMemcpyToSymbol(g_clocks, z, sizeof(z));
}
"""
VARIANTS["clocks"] = CLOCKS


def fail(msg: str) -> None:
    print(f"k7_profile: {msg}", file=sys.stderr)
    sys.exit(1)


def edited(edits) -> str:
    text = (CSRC / "forward_probs.cu").read_text()
    for anchor, new in edits:
        if text.count(anchor) != 1:
            fail(f"anchor not found once in forward_probs.cu: {anchor!r}")
        text = text.replace(anchor, new)
    return text


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available; this measurement needs an NVIDIA GPU")
    if not (CSRC / "forward_probs.cu").exists():
        fail(f"run from a checkout of the repository ({CSRC} missing)")
    sys.path.insert(0, str(HERE))
    from chip_smoke import k7_exact_inputs
    from streamz_tpu_torch import _cuda_build, bench
    from streamz_tpu_torch.nn import forward_kernel as fk
    from streamz_tpu_torch.nn.model import init_params
    from streamz_tpu_torch.runtime.measure import chain_timer

    card = bench.card_line()
    work_dir = Path(tempfile.mkdtemp(prefix="streamz_k7_profile_"))
    procs = {}
    for name, edits in VARIANTS.items():
        d = work_dir / name
        d.mkdir()
        (d / "forward_probs.cu").write_text(edited(edits) + (READ_CLOCKS if name == "clocks" else ""))
        (d / "hopper.cuh").write_text((CSRC / "hopper.cuh").read_text())
        cmd = [_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS, f"-I{d}", "-o",
               str(d / "libforward_probs.so"), str(d / "forward_probs.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            fail(f"nvcc failed for {name}:\n{logs[name][-3000:]}")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | {card}")
    params = {k: v.contiguous() for k, v in init_params(*DIMS[:3], DIMS[3], seed=0,
                                                        device=dev).items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (R, DIMS[0]))
                         .astype(np.float32)).to(dev)
    e_params, e_x = k7_exact_inputs(*DIMS, R, dev, seed=1)
    want = fk.forward_probs_plain(e_params, e_x, NS)
    stream = torch.cuda.current_stream().cuda_stream
    report = {"card": card, "rows": R, "dims": list(DIMS), "ms": {}}
    launchers = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(work_dir / name / "libforward_probs.so"))
        fk._declare(lib)
        nbytes = int(lib.streamz_forward_probs_workspace(*DIMS))
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        out = torch.empty((R, DIMS[3]), device=dev)

        def launch(lib=lib, work=work, out=out, nbytes=nbytes, p=params, xx=x):
            rc = lib.streamz_forward_probs(
                xx.data_ptr(), R, DIMS[0], NS, *(p[k].data_ptr() for k in fk.PARAM_NAMES),
                *DIMS[1:], work.data_ptr(), nbytes, out.data_ptr(), stream)
            if rc != 0:
                fail(f"{name}: launch failed, CUDA error {rc}")

        launch(p=e_params, xx=e_x)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        if err > TOL:
            fail(f"{name} disagrees with the plain version: {err:.3e}")
        launchers[name] = launch
        lines = logs[name].splitlines()
        regs = [ln.strip() for ln in lines if "Used" in ln or "spill" in ln]
        notes = {f: sum(f in ln for ln in lines) for f in ("C7514", "C7517", "C7519")}
        report.setdefault("ptxas_notes", {})[name] = notes
        print(f"[{name}] max abs err {err:.2e} on exact-sum inputs; ptxas: " + "; ".join(regs)
              + f"; wgmma serialized (C7514) {notes['C7514']}, waits injected (C7517) "
              f"{notes['C7517']}, arrives injected (C7519) {notes['C7519']}")
    for name in [*VARIANTS, "shipped"]:
        ms = min(chain_timer(launchers[name], iters=50, repeats=1) * 1e3 for _ in range(2))
        report["ms"].setdefault(name, []).append(ms)
        print(f"[{name}] {ms:.4f} ms at [{R}, {DIMS[0]}] -> {DIMS[3]} | {card}")
    # One launch of the marked copy: each phase's cycles as a share of the
    # consumers' (0-9) or the producers' (10, 11) total.
    lib = ctypes.CDLL(str(work_dir / "clocks" / "libforward_probs.so"))
    lib.streamz_zero_clocks()
    launchers["clocks"]()
    torch.cuda.synchronize()
    clocks = (ctypes.c_ulonglong * 16)()
    lib.streamz_read_clocks(clocks)
    shares = {ph: clocks[i] / clocks[11 if i in (10, 11) else 8]
              for i, ph in enumerate(PHASES) if i not in (8, 11)}
    report["shares"] = shares
    print("[clocks] consumers' cycles (phases 0-6 add up to the total; ring and wgmma "
          "waits lie inside the products), then the producers': " + ", ".join(
              f"{ph} {v:.1%}" for ph, v in shares.items())
          + f"; consumer cycles a warpgroup {clocks[8] / (2 * 66 * 2):.0f} | {card}")
    lib = ctypes.CDLL(str(work_dir / "shipped" / "libforward_probs.so"))
    fk._declare(lib)
    packed = torch.empty(int(lib.streamz_forward_probs_packed_elems(*DIMS)),
                         dtype=torch.bfloat16, device=dev)
    pack_ms = chain_timer(lambda: lib.streamz_forward_probs_pack(
        params["w1"].data_ptr(), params["w2"].data_ptr(), params["w3"].data_ptr(), *DIMS,
        packed.data_ptr(), stream), iters=50) * 1e3
    with torch.no_grad():
        h1 = torch.relu(x @ params["w1"] + params["b1"]).to(torch.bfloat16)
        h2 = torch.tanh(h1.float() @ params["w2"] + params["b2"]).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    wb = [params[k].to(torch.bfloat16) for k in ("w1", "w2", "w3")]
    lib_ms = chain_timer(lambda: (xb @ wb[0], h1 @ wb[1], h2 @ wb[2]), iters=20) * 1e3
    report.update({"pack_ms": pack_ms, "bf16_matmuls_ms": lib_ms})
    print(f"[pack] the pack kernel alone {pack_ms:.4f} ms; the three products as bf16 "
          f"torch.matmul {lib_ms:.4f} ms | {card}")
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "k7_profile.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
