"""Time the bf16 attention forward of ``csrc/attention_fwd_sm90.cuh`` with
one and with two consumer warpgroups (64- and 128-row query tiles), beside
SDPA, and hold each against its plain version.

    python -m apex_tpu_torch.tools.fwd_rows

The entries build one tile size each (``attention_short.cu`` one
warpgroup, ``attention_mid.cu`` and ``attention_flash.cu`` two), so this
builds the instances without segment ids, dropout or a bias of both sizes
into one small library of its own (a few seconds of ``nvcc``), checks them
at ragged shapes in both rounding orders (the short/mid one, ``(q . k) *
scale``, and the flash one, ``q * scale`` rounded first), and times them
at the shapes of the short entry's main paths (serving prefill b=1 h=8
s=512 d=128; BERT-large b=16 h=16 s=512 d=64), the mid one (b=8 h=8
s=1024) and the flash one (b=2 h=8 s=4096), causal.  Device ms per call
from a CUDA graph of 20 calls after a warm-up; then the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import math
import subprocess

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops import attention_flash as flash
from apex_tpu_torch.ops import attention_short as short
from apex_tpu_torch.ops import common

_SOURCE = r"""
#include "attention_fwd_sm90.cuh"

#define RUN(D, NC, QS)                                                      \
  attn::sm90::launch<D, NC, false, false, false, QS>(                       \
      q, k, v, nullptr, nullptr, out, lse, bh, 1, sq, sk, causal, scale,    \
      attn::Dropout{0, 0, 0.0f}, attn::Bias{nullptr, 0, 0}, s)

extern "C" int fwd_rows(const void* q, const void* k, const void* v,
                        void* out, float* lse, int bh, int sq, int sk, int d,
                        int nc, int qscale, int causal, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BOTH(D, NC) (qscale ? RUN(D, NC, true) : RUN(D, NC, false))
  if (d == 128 && nc == 1) return BOTH(128, 1);
  if (d == 128 && nc == 2) return BOTH(128, 2);
  if (d == 64 && nc == 1) return BOTH(64, 1);
  if (d == 64 && nc == 2) return BOTH(64, 2);
  return cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""

#: (b*h, sq, sk, d, causal): the ragged cases each instance is held on
CASES = ((3, 1000, 1000, 128, False), (3, 700, 1100, 128, True),
         (3, 1000, 1000, 64, True), (3, 700, 1100, 64, False),
         (3, 100, 100, 128, True))

#: (label, b, h, s, d, query-tile sizes, flash order): the timed shapes
SHAPES = (("short, serving prefill", 1, 8, 512, 128, (1, 2), False),
          ("short_fwd_seg's shape, BERT-large", 16, 16, 512, 64, (1, 2),
           False),
          ("mid, flagship training", 8, 8, 1024, 128, (2,), False),
          ("flash, Llama-mode training", 2, 8, 4096, 128, (2,), True))


def _build():
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = common.BUILD_DIR / "fwd_rows.cu"
    lib = common.BUILD_DIR / "fwd_rows.so"
    src.write_text(_SOURCE)
    out = subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-I",
                          str(common.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed:\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(str(lib)).fwd_rows
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    fn = _build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run(q, k, v, nc, qscale, causal):
        bh, sq, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty(bh, sq, device=dev)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), bh, sq, k.shape[1], d, nc, int(qscale),
                 int(causal), d ** -0.5, common.stream_of(q))
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return out, lse

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    for bh, sq, sk, d, causal in CASES:
        q, k, v = randn(bh, sq, d), randn(bh, sk, d), randn(bh, sk, d)
        for nc in (1, 2):
            for qscale in (False, True):
                got, lse = run(q, k, v, nc, qscale, causal)
                plain = (flash._flash_fwd_plain if qscale
                         else short._short_fwd_plain)
                want, want_lse = plain(q, k, v, causal, d ** -0.5)
                top = want.float().abs().max().item()
                tol = 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7)
                err = (got.float() - want.float()).abs().max().item()
                lse_err = (lse - want_lse).abs().max().item()
                if not (err <= tol and lse_err <= 1e-3):
                    raise SystemExit(
                        f"bh={bh} sq={sq} sk={sk} d={d} causal={causal} "
                        f"rows={64 * nc} qscale={qscale}: error {err:.3g} "
                        f"(tolerance {tol:.3g}), lse {lse_err:.3g}")
    print(f"held: {len(CASES)} ragged cases x 64/128 rows x both orders "
          "(two bf16 ulps, lse 1e-3)")

    def ms(call, iters=20):
        # the device's time: the calls captured in one CUDA graph, so a
        # small shape's host launch cost stays out
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

    for label, b, h, s, d, sizes, qscale in SHAPES:
        q, k, v = (randn(b * h, s, d) for _ in range(3))
        times = [f"{64 * nc} rows "
                 f"{ms(lambda: run(q, k, v, nc, qscale, True)):.4f} ms"
                 for nc in sizes]
        q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))
        sdpa = ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                         is_causal=True))
        print(f"{label} (b={b} h={h} s={s} d={d} causal): "
              f"{', '.join(times)}; SDPA {sdpa:.4f} ms", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
