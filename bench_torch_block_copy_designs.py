#!/usr/bin/env python3
"""Time of the port's random-row block gather (K6, `row_block_gather`)
against the designs it was measured against, on one CUDA card.

    python3 bench_torch_block_copy_designs.py

The port issues a block's 256 descriptors from eight lanes (lane 0 of each
warp, every eighth descriptor, each on its own share of the ring's W
slots); a lane stores a slot when the slot is needed again and waits for
that store to read it (`wait_group.read 0`) before the reload
(`meepoembedding_tpu_torch/csrc/row_block_copy.cu`). This script builds one
parameterised kernel of the same copies with nvcc (into
build/block_copy_designs/) and times its settings beside the port:

  lanes             issuing lanes a block (1, 2, 4, 8; at most W)
  a block           descriptors a block (256, the TPU's grid step, or 64)
  stores in flight  each store issued as soon as its load lands; a slot's
                    reload waits only for its own store (`wait_group.read
                    N`, N the lane's later stores rounded down to a power
                    of two)
  loads only        no stores at all (the output is not written, so not
                    checked): what the loads alone cost

On bench.dma's plane and stream: a [2^22, 128] f32 plane, 8 index sets of
2^16 distinct bases (`bench.dma.index_sets`, seed 0), at the (R, W) points
R = 1 x W 8, 32, 128, 256, R = 4 x W 32, R = 16 x W 8 and R = 32 x W 14.
Time: CUDA events around 3 passes over the 8 sets, the best of 3, in us a
call. Every design that stores is checked bit for bit against the port on
the same bases. Prints one line a point, the card's name and power limit,
and exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from meepoembedding_tpu_torch.bench import dma
from meepoembedding_tpu_torch.kernels import _build, row_block_gather

ROOT = Path(__file__).resolve().parent

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
__device__ __forceinline__ void wait_read(int n) {
#define WAIT_READ(k) \
  if (n >= k) { asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(k) : "memory"); return; }
  WAIT_READ(128) WAIT_READ(64) WAIT_READ(32) WAIT_READ(16) WAIT_READ(8) WAIT_READ(4)
  WAIT_READ(2) WAIT_READ(1)
#undef WAIT_READ
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__global__ void gather(const char* plane, char* out, const int32_t* base, long long n,
                       long long nrow, int R, int slots, int issuers, int per_block, int serial,
                       int stores) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long bytes = (long long)R * 512;
  unsigned char* ring = smem;
  uint64_t* bar = (uint64_t*)(smem + (size_t)slots * bytes);
  int32_t* first = (int32_t*)(bar + slots);
  const long long d0 = (long long)blockIdx.x * per_block;
  const int cnt = (int)(n - d0 < per_block ? n - d0 : per_block);
  const long long top = nrow - R;
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    const long long b = base[d0 + j];
    first[j] = (int32_t)(b < 0 ? 0 : (b > top ? top : b));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sa(&bar[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int k = threadIdx.x / 32;
  if (threadIdx.x % 32 != 0 || k >= issuers) return;
  const int per = slots / issuers + (k < slots % issuers);
  const int s0 = k * (slots / issuers) + (k < slots % issuers ? k : slots % issuers);
  const int m = cnt > k ? (cnt - k + issuers - 1) / issuers : 0;
  const uint32_t nbytes = (uint32_t)bytes;
  auto slot = [&](int i) { return s0 + i % per; };
  auto landed = [&](int i) { return sa(&bar[slot(i)]); };
  auto parity = [&](int i) { return (uint32_t)((i / per) & 1); };
  auto load = [&](int i) {
    const char* src = plane + (long long)first[k + i * issuers] * 512;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(landed(i)), "r"(nbytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(sa(ring + (size_t)slot(i) * bytes)), "l"(src), "r"(nbytes), "r"(landed(i))
        : "memory");
  };
  auto store = [&](int i) {
    while (!mbar_try(landed(i), parity(i))) {}
    if (!stores) return;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(out + (d0 + k + i * issuers) * bytes),
                 "r"(sa(ring + (size_t)slot(i) * bytes)), "r"(nbytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  };
  int stored = 0;
  for (int i = 0; i < m; ++i) {
    if (i >= per) {
      const int old = i - per;
      for (; stored <= old; ++stored) store(stored);
      wait_read(serial ? 0 : stored - 1 - old);
    }
    load(i);
    if (!serial)
      for (; stored < i && mbar_test(landed(stored), parity(stored)); ++stored) store(stored);
  }
  for (; stored < m; ++stored) store(stored);
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
}  // namespace

extern "C" int design_gather(const void* plane, void* out, const void* base, long long n,
                             long long nrow, int R, int slots, int issuers, int per_block,
                             int serial, int stores, void* stream) {
  const size_t smem = (size_t)slots * (R * 512 + 8) + per_block * 4;
  if (smem > 232448 || slots < issuers || slots > per_block) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gather, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       232448);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  gather<<<blocks, 32 * issuers, smem, (cudaStream_t)stream>>>(
      (const char*)plane, (char*)out, (const int32_t*)base, n, nrow, R, slots, issuers,
      per_block, serial, stores);
  return (int)cudaGetLastError();
}
"""

# (label, issuing lanes, descriptors a block, serial stores, stores)
DESIGNS = (
    ("1 lane", 1, 256, 1, 1),
    ("1 lane, stores in flight", 1, 256, 0, 1),
    ("1 lane, loads only", 1, 256, 1, 0),
    ("2 lanes", 2, 256, 1, 1),
    ("4 lanes", 4, 256, 1, 1),
    ("8 lanes, stores in flight", 8, 256, 0, 1),
    ("1 lane, 64 a block", 1, 64, 1, 1),
)
POINTS = ((1, 8), (1, 32), (1, 128), (1, 256), (4, 32), (16, 8), (32, 14))


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "block_copy_designs"
    out.mkdir(parents=True, exist_ok=True)
    (out / "designs.cu").write_text(SOURCE)
    lib = out / "libdesigns.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "designs.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.design_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 6 + [
                                  ctypes.c_void_p]
    lib.design_gather.restype = ctypes.c_int
    return lib


def call_us(fn, sets) -> float:
    """The best of 3 timings of 3 passes over the index sets, us a call."""
    fn(sets[0])
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            for idx in sets:
                fn(idx)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3 / (3 * len(sets)))
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = build()
    nrow, n = 1 << 22, 1 << 16
    plane = torch.randn((nrow, 128), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    sets = [s[0] for s in dma.index_sets(nrow, n, 8, 1, dev)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for R, W in POINTS:
        out = torch.empty((n * R, 128), device=dev)
        want = row_block_gather(plane, sets[1], R, W)
        cols = [f"port (8 lanes) {call_us(lambda i: row_block_gather(plane, i, R, W), sets):.1f}"]
        for label, lanes, per_block, serial, stores in DESIGNS:
            if W > per_block:
                continue
            lanes = min(lanes, W)

            def fn(i, lanes=lanes, per_block=per_block, serial=serial, stores=stores):
                err = lib.design_gather(plane.data_ptr(), out.data_ptr(), i.data_ptr(), n, nrow,
                                        R, W, lanes, per_block, serial, stores, stream)
                if err:
                    raise RuntimeError(f"{label}: CUDA error {err}")

            out.zero_()
            fn(sets[1])
            torch.cuda.synchronize()
            if stores and not torch.equal(out, want):
                raise AssertionError(f"{label} at R={R}, W={W} disagrees with the port")
            cols.append(f"{label} {call_us(fn, sets):.1f}")
        print(f"R={R} W={W} (bound {(2 * n * R * 512 + 4 * n) / 3.35e12 * 1e6:.1f} us): "
              + "; ".join(cols), flush=True)
    print(f"R=1 torch.index_select {call_us(lambda i: plane.index_select(0, i), sets):.1f}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
