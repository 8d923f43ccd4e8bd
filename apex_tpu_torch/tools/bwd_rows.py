"""Hold and time the bf16 attention backward of ``csrc/attention_bwd_sm90.cuh``
alone: its dK/dV and dQ kernels with one and with two consumer warpgroups
(64- and 128-key dK/dV blocks, 64- and 128-row dQ blocks), with a ring of
two and of three stages.

    python -m apex_tpu_torch.tools.bwd_rows

The short, mid and flash entries build one block size
(``ATTN_BWD_WARPGROUPS`` in ``attention_common.cuh``, ``kBwdWarpgroups``
in ``attention_flash.cu``), one ring (``ATTN_BWD_STAGES``) and every
variant, minutes of ``nvcc``; this builds
the instances without segment ids, dropout or a bias of both sizes into
one small library a ring (``-DATTN_BWD_STAGES=2`` and ``3``, the two
``nvcc`` at once, seconds), prints each instance's registers and spill
stores, holds each kernel at ragged shapes against ``_short_bwd_plain``
(dq, dk, dv within two bf16 ulps of their largest magnitude; delta =
rowsum(dO * O) from PyTorch, which ``attn_delta_kernel`` and
``flash_delta`` compute in the entries), one of them causal past 4096
tokens with sq no multiple of 4 and sk odd (a block wraps the ring up
to 32 times), and times each kernel alone at the shapes of the short entry's
main paths (b=8 h=8 s=512 d=128 causal; BERT-large's b=16 h=16 s=512
d=64, not causal) and the mid one's (the flagship's b=8 h=8 s=1024 d=128,
causal) with two stages, as those entries build them, and at the flash
one's (the Llama mode's b=2 h=8 s=4096 d=128, causal) with two and three.
Device ms per call from a CUDA graph of 20 calls after a warm-up; then the
card's name and power limit.  ``chip_smoke.py`` phase 2 holds every
instance (``bwd_sm90_kernels``).
"""

from __future__ import annotations

import ctypes
import itertools
import math
import subprocess

import torch

from apex_tpu_torch.ops import attention_short as short
from apex_tpu_torch.ops import common
from chip_smoke import sm90_instances

_SOURCE = r"""
#include "attention_bwd_sm90.cuh"

#define DKV(D, NC) \
  attn::sm90::launch_dkv<D, NC, false, false, false>(q, k, v, dout, prm, bh, s)
#define DQ(D, NC) \
  attn::sm90::launch_dq<D, NC, false, false, false, false>(q, k, v, dout, \
                                                           prm, bh, s)
#define BOTH(D, NC) (which == 0 ? DKV(D, NC) : DQ(D, NC))

// which: 0 the dK/dV kernel, 1 the dQ kernel.
extern "C" int bwd_rows(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv,
                        int bh, int sq, int sk, int d, int nc, int which,
                        int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const attn::sm90::BwdParams prm{
      nullptr, nullptr, lse, delta, static_cast<attn::bf16*>(dq),
      static_cast<attn::bf16*>(dk), static_cast<attn::bf16*>(dv), nullptr,
      1, sq, sk, causal, scale, attn::Dropout{0, 0, 0.0f},
      attn::Bias{nullptr, 0, 0}};
  if (d == 128 && nc == 1) return BOTH(128, 1);
  if (d == 128 && nc == 2) return BOTH(128, 2);
  if (d == 64 && nc == 1) return BOTH(64, 1);
  if (d == 64 && nc == 2) return BOTH(64, 2);
  return cudaErrorInvalidValue;
}
"""

#: (b*h, sq, sk, d, causal): the ragged cases each kernel is held on
CASES = ((3, 1000, 1000, 128, False), (3, 700, 1100, 128, True),
         (3, 1000, 1000, 64, True), (3, 500, 300, 64, False),
         (3, 100, 100, 128, True), (2, 4098, 4131, 128, True))

#: stages of the ring, one library each
STAGES = (2, 3)

#: (label, b, h, s, d, causal, stages): the timed shapes
SHAPES = (("short_bwd, b=8 s=512", 8, 8, 512, 128, True, (2,)),
          ("short_bwd_seg's shape, BERT-large", 16, 16, 512, 64, False,
           (2,)),
          ("mid_bwd, flagship training", 8, 8, 1024, 128, True, (2,)),
          ("flash_bwd_dkv + flash_bwd_dq, Llama long training", 2, 8, 4096,
           128, True, STAGES))


def _build() -> dict:
    """``{stages: the loaded entry}``, the libraries compiled at once."""
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stages in STAGES:
        src = common.BUILD_DIR / f"bwd_rows_{stages}.cu"
        lib = common.BUILD_DIR / f"bwd_rows_{stages}.so"
        src.write_text(_SOURCE)
        procs[stages] = lib, subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-I", str(common.CSRC),
             f"-DATTN_BWD_STAGES={stages}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for stages, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed ({stages} stages):\n{out}")
        for inst, (regs, spill) in sorted(sm90_instances(out).items()):
            print(f"{stages} stages, {inst}: {regs} registers, {spill} bytes "
                  "of spill stores")
        fn = ctypes.CDLL(str(lib)).bwd_rows
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[stages] = fn
    return fns


def main() -> None:
    fns = _build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def operands(bh, sq, sk, d, causal):
        q, dout = randn(bh, sq, d), randn(bh, sq, d)
        k, v = randn(bh, sk, d), randn(bh, sk, d)
        out, lse = short._short_fwd_plain(q, k, v, causal, d ** -0.5)
        delta = (dout.float() * out.float()).sum(-1)
        return q, k, v, out, dout, lse, delta

    def run(ops, stages, nc, which, causal):
        q, k, v, out, dout, lse, delta = ops
        bh, sq, d = q.shape
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        err = fns[stages](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
            bh, sq, k.shape[1], d, nc, which, int(causal), d ** -0.5,
            common.stream_of(q))
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return grads

    for bh, sq, sk, d, causal in CASES:
        ops = operands(bh, sq, sk, d, causal)
        q, k, v, out, dout, lse, _ = ops
        want = short._short_bwd_plain(q, k, v, out, dout, lse, None, causal,
                                      d ** -0.5)
        for stages, nc in itertools.product(STAGES, (1, 2)):
            dkv = run(ops, stages, nc, 0, causal)
            dq = run(ops, stages, nc, 1, causal)
            for name, got, ref in (("dq", dq[0], want[0]),
                                   ("dk", dkv[1], want[1]),
                                   ("dv", dkv[2], want[2])):
                top = ref.float().abs().max().item()
                tol = 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7)
                err = (got.float() - ref.float()).abs().max().item()
                if not err <= tol:
                    raise SystemExit(
                        f"bh={bh} sq={sq} sk={sk} d={d} causal={causal} "
                        f"{64 * nc}-row blocks, {stages} stages {name}: "
                        f"error {err:.3g} (tolerance {tol:.3g})")
    print(f"held: {len(CASES)} ragged cases x 64/128-row blocks x "
          f"{STAGES} stages (two bf16 ulps)")

    def ms(call, iters=20):
        # the device's time: the calls captured in one CUDA graph, so the
        # host's launch cost stays out
        for _ in range(3):
            call()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                call()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for label, b, h, s, d, causal, rings in SHAPES:
        ops = operands(b * h, s, s, d, causal)
        times = []
        for stages in rings:
            for which, name in ((0, "dK/dV"), (1, "dQ")):
                times += [
                    f"{name} {64 * nc} rows {stages} stages "
                    f"{ms(lambda: run(ops, stages, nc, which, causal)):.4f} ms"
                    for nc in (1, 2)]
        print(f"{label} (b={b} h={h} s={s} d={d}"
              f"{' causal' if causal else ''}): {', '.join(times)}",
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
