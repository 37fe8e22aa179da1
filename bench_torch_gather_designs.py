#!/usr/bin/env python3
"""Device time of the port's row gather (K2) and row add (K3) against the
shape-specific designs they were measured against, on one CUDA card.

    python3 bench_torch_gather_designs.py [--seed 0]

The port ships one thread per vector for every row shape
(`meepoembedding_tpu_torch/csrc/row_gather.cu`, `row_scatter_add.cu`).
This script builds the alternatives with nvcc (into build/gather_designs/)
and times each beside the port's kernel on the same inputs, in turns, with
torch.profiler (device time of the kernels a call launches; the median of
4 rounds of 8 calls on rotating index sets, after one warm-up round):

  warp a row    rows of 512 B and up: a warp copies a row, the row's index
                in a register (loaded a batch ahead), rows dealt round one
                wave of warps.
  chunks        rows under 512 B: 32 consecutive rows a warp, their indices
                in one coalesced load passed to each row's lanes by a
                shuffle, one wave of warps.
  4 a thread    4-byte rows: four indices a thread in one int4 load, four
                scattered loads before the stores (gather; add and
                fetch-add).
  TMA           two planes of 1 KB rows: cp.async.bulk copies global ->
                shared -> global, one warp a block, 16 stages, mbarriers.

The shapes are the main paths' on a 2^27-slot table: the probe's key pair
(2 x [2^19, 256] int32, n = 131,072), insert planning's (2 x [2^20, 128],
n = 106,496), the values gather ([2^27, 32] f32, n = 131,072) and the
rowwise accumulator's flat view ([2^27, 1] f32, n = 106,496, 34,941 kept).
Indices are random from --seed, with the request's and the step's padding
(a repeated row) at the end, as the paths have it. Every design's output is
checked bit for bit against the port's. As a yardstick of the rate the card
reaches, one contiguous `copy_` of the probe pair's output size (268 MB read
and written). Prints one line a shape and design, the card's name and power
limit, and exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from meepoembedding_tpu_torch.kernels import _build, row_gather_multi, row_scatter_add

ROOT = Path(__file__).resolve().parent

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr unsigned kFull = 0xffffffffu;
struct P { const uint4* plane[2]; uint4* out[2]; };

__device__ __forceinline__ long long clamp_row(long long r, long long rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

template <typename Kern>
long long wave(Kern k, int threads, size_t smem = 0) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, threads, smem);
  return (long long)sms * (per > 0 ? per : 1);
}

long long cap(long long b, long long c) { return b < c ? b : c; }

// a warp a row (vpr >= 32 vectors), S rows a batch, indices one batch ahead
template <int K, int S>
__global__ void warp_rows(const P gp, const int32_t* __restrict__ idx, long long n,
                          long long rows, int vpr) {
  const int lane = threadIdx.x & 31;
  const long long W = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int next[S];
#pragma unroll
  for (int u = 0; u < S; ++u)
    next[u] = w + u * W < n ? (int)clamp_row(__ldg(idx + w + u * W), rows) : 0;
  for (long long j0 = w; j0 < n; j0 += S * W) {
    int r[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      r[u] = next[u];
      const long long a = j0 + (S + u) * W;
      next[u] = a < n ? (int)clamp_row(__ldg(idx + a), rows) : 0;
    }
    for (int c = lane; c < vpr; c += 32) {
      uint4 buf[K][S];
#pragma unroll
      for (int p = 0; p < K; ++p)
#pragma unroll
        for (int u = 0; u < S; ++u)
          if (j0 + u * W < n) buf[p][u] = __ldg(gp.plane[p] + (long long)r[u] * vpr + c);
#pragma unroll
      for (int p = 0; p < K; ++p)
#pragma unroll
        for (int u = 0; u < S; ++u)
          if (j0 + u * W < n) gp.out[p][(j0 + u * W) * vpr + c] = buf[p][u];
    }
  }
}

// 32-row chunks (vpr < 32 vectors), indices by shuffle, B steps a batch
template <int K, int B>
__global__ void chunks(const P gp, const int32_t* __restrict__ idx, long long n,
                       long long rows, int vpr_log2) {
  const int vpr = 1 << vpr_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane >> vpr_log2, c = lane & (vpr - 1), rps = 32 >> vpr_log2;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long W = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long end = n * (w + 1) / W;
  for (long long base = n * w / W; base < end; base += 32) {
    const int count = end - base < 32 ? (int)(end - base) : 32;
    const int mine = lane < count ? (int)clamp_row(__ldg(idx + base + lane), rows) : 0;
    for (int t0 = 0; t0 < vpr; t0 += B) {
      if (t0 * rps >= count) break;
      long long from[B], to[B];
      bool ok[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int row = (t0 + u) * rps + sub;
        const int r = __shfl_sync(kFull, mine, row & 31);
        ok[u] = t0 + u < vpr && row < count;
        from[u] = (long long)r * vpr + c;
        to[u] = (base + row) * vpr + c;
      }
      uint4 buf[K][B];
#pragma unroll
      for (int p = 0; p < K; ++p)
#pragma unroll
        for (int u = 0; u < B; ++u) if (ok[u]) buf[p][u] = __ldg(gp.plane[p] + from[u]);
#pragma unroll
      for (int p = 0; p < K; ++p)
#pragma unroll
        for (int u = 0; u < B; ++u) if (ok[u]) gp.out[p][to[u]] = buf[p][u];
    }
  }
}

// 4-byte rows: 4 indices a thread; gather (kAdd false) or add / fetch-add
template <bool kAdd, bool kOld>
__global__ void elems(uint32_t* __restrict__ plane, const int4* __restrict__ idx4,
                      const uint4* __restrict__ upd4, uint4* __restrict__ out4, long long n,
                      long long rows) {
  const long long n4 = n >> 2, stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n4; q += stride) {
    const int4 i = __ldg(idx4 + q);
    const int r[4] = {i.x, i.y, i.z, i.w};
    uint32_t a[4];
    bool k[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      k[t] = kAdd ? (r[t] >= 0 && r[t] < rows) : true;
      const long long at = kAdd ? r[t] : clamp_row(r[t], rows);
      a[t] = k[t] ? plane[at] : 0u;
    }
    if (kAdd) {
      const uint4 u = __ldg(upd4 + q);
      const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (k[t]) plane[r[t]] = __float_as_uint(__uint_as_float(a[t]) + __uint_as_float(v[t]));
    }
    if (!kAdd || kOld) out4[q] = make_uint4(a[0], a[1], a[2], a[3]);
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const long long j = (n4 << 2) + threadIdx.x;
    const int r = __ldg((const int32_t*)idx4 + j);
    const bool k = kAdd ? (r >= 0 && r < rows) : true;
    const uint32_t a = k ? plane[kAdd ? r : clamp_row(r, rows)] : 0u;
    if (kAdd && k)
      plane[r] = __float_as_uint(__uint_as_float(a) + __uint_as_float(((const uint32_t*)upd4)[j]));
    if (!kAdd || kOld) ((uint32_t*)out4)[j] = a;
  }
}

__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(sa(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// TMA: one warp a block, lane 0 issues; block b copies rows b, b + G, ...
// through S stages of two rows; loads run S - L rows ahead of the stores.
template <int S, int L>
__global__ void tma2(const char* p0, const char* p1, char* o0, char* o1,
                     const int32_t* __restrict__ idx, long long n, long long rows, int rb) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[S];
  const int lane = threadIdx.x;
  const long long G = gridDim.x, b = blockIdx.x;
  const long long cnt = b < n ? (n - b + G - 1) / G : 0;
  if (lane == 0) {
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sa(&bar[s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  auto chunk = [&](long long c) -> int {
    const long long i = c * 32 + lane;
    return i < cnt ? __ldg(idx + b + i * G) : 0;
  };
  int cur = chunk(0), nxt = chunk(1);
  long long cur_c = 0;
  auto load = [&](long long q) {
    const long long c = q >> 5;
    if (c != cur_c) { cur = nxt; nxt = chunk(c + 1); cur_c = c; }
    const long long r = clamp_row(__shfl_sync(kFull, cur, (int)(q & 31)), rows);
    if (lane == 0 && q < cnt) {
      const int s = (int)(q % S);
      unsigned char* dst = smem + (size_t)s * 2 * rb;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(sa(&bar[s])), "r"(2 * rb) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                   ::"r"(sa(dst)), "l"(p0 + r * rb), "r"(rb), "r"(sa(&bar[s])) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                   ::"r"(sa(dst + rb)), "l"(p1 + r * rb), "r"(rb), "r"(sa(&bar[s])) : "memory");
    }
  };
  for (long long q = 0; q < S - L; ++q) load(q);
  for (long long i = 0; i < cnt; ++i) {
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(L - 1) : "memory");
    load(i + S - L);
    if (lane == 0) {
      const int s = (int)(i % S);
      for (long long t = 0; !mbar_try(&bar[s], (uint32_t)((i / S) & 1)); ++t)
        if (t > (1LL << 22)) asm volatile("trap;");
      const unsigned char* src = smem + (size_t)s * 2 * rb;
      const long long j = b + i * G;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(o0 + j * rb), "r"(sa(src)), "r"(rb) : "memory");
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(o1 + j * rb), "r"(sa(src + rb)), "r"(rb) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
}  // namespace

extern "C" int design_rows(int design, int k, void* const* planes, void* const* outs,
                           const void* idx, long long n, long long rows, long long row_bytes,
                           void* stream) {
  P gp{{(const uint4*)planes[0], (const uint4*)planes[k - 1]}, {(uint4*)outs[0], (uint4*)outs[k - 1]}};
  cudaStream_t s = (cudaStream_t)stream;
  const int vpr = (int)(row_bytes / 16);
  int vl = 0;
  while ((1 << vl) < vpr) ++vl;
  const int32_t* i = (const int32_t*)idx;
  if (design == 0 && k == 1) {
    warp_rows<1, 8><<<(unsigned)cap((n + 7) / 8, wave(warp_rows<1, 8>, 256)), 256, 0, s>>>(gp, i, n, rows, vpr);
  } else if (design == 0) {
    warp_rows<2, 4><<<(unsigned)cap((n + 7) / 8, wave(warp_rows<2, 4>, 256)), 256, 0, s>>>(gp, i, n, rows, vpr);
  } else if (design == 1 && k == 1) {
    chunks<1, 8><<<(unsigned)cap((n + 255) / 256, wave(chunks<1, 8>, 256)), 256, 0, s>>>(gp, i, n, rows, vl);
  } else if (design == 1) {
    chunks<2, 4><<<(unsigned)cap((n + 255) / 256, wave(chunks<2, 4>, 256)), 256, 0, s>>>(gp, i, n, rows, vl);
  } else {
    const size_t smem = 16 * 2 * row_bytes;
    cudaFuncSetAttribute(tma2<16, 8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    tma2<16, 8><<<(unsigned)wave(tma2<16, 8>, 32, smem), 32, smem, s>>>(
        (const char*)planes[0], (const char*)planes[1], (char*)outs[0], (char*)outs[1], i, n,
        rows, (int)row_bytes);
  }
  return (int)cudaGetLastError();
}

// mode 0: gather, 1: add, 2: fetch-add (f32 planes)
extern "C" int design_elems(int mode, void* plane, const void* idx, const void* upd, void* out,
                            long long n, long long rows, void* stream) {
  const unsigned blocks = (unsigned)cap((n / 4 + 127) / 128 > 0 ? (n / 4 + 127) / 128 : 1, 132 * 16);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* p = (uint32_t*)plane;
  const int4* i = (const int4*)idx;
  if (mode == 0) elems<false, false><<<blocks, 128, 0, s>>>(p, i, (const uint4*)upd, (uint4*)out, n, rows);
  else if (mode == 1) elems<true, false><<<blocks, 128, 0, s>>>(p, i, (const uint4*)upd, (uint4*)out, n, rows);
  else elems<true, true><<<blocks, 128, 0, s>>>(p, i, (const uint4*)upd, (uint4*)out, n, rows);
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "gather_designs"
    out.mkdir(parents=True, exist_ok=True)
    (out / "designs.cu").write_text(SOURCE)
    lib = out / "libdesigns.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "designs.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def device_us(fns) -> float:
    """Device time of one call under torch.profiler: all the kernels the
    calls launch, over one pass through `fns`."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                for e in evs)
    return total / len(fns)


def compare(label, designs, check, rounds=5) -> None:
    """Each design's device time, in turns (the order reversed every other
    round), the first round dropped; raises unless each matches the port."""
    for name, _ in designs[1:]:
        if not check(name):
            raise AssertionError(f"{label}: {name} disagrees with the port's kernel")
    times = {name: [] for name, _ in designs}
    for r in range(rounds):
        for name, fns in (designs if r % 2 == 0 else designs[::-1]):
            times[name].append(device_us(fns))
    for name, t in times.items():
        print(f"{label}: {name}: {np.median(t[1:]):.2f} us of device time a call "
              f"(rounds: {', '.join(f'{x:.2f}' for x in t[1:])})", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_gather_designs: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    lib = build()
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    rows_fn = lib.design_rows
    rows_fn.argtypes = [I, I, ctypes.POINTER(P), ctypes.POINTER(P), P, L, L, L, P]
    rows_fn.restype = I
    elems_fn = lib.design_elems
    elems_fn.argtypes = [I, P, P, P, P, L, L, P]
    elems_fn.restype = I
    stream = _build.raw_stream(dev)

    def indices(R, n, live, zero_frac=0.0):
        out = []
        for k in range(8):
            i = torch.randint(0, R, (n,), device=dev, dtype=torch.int32, generator=g)
            i[live:] = 12345 + k  # the padding: one repeated row
            if zero_frac:
                i[torch.rand((n,), device=dev, generator=g) < zero_frac] = 0
            out.append(i)
        return out

    def gather_case(label, planes, n, live, names, zero_frac=0.0):
        idxs = indices(planes[0].shape[0], n, live, zero_frac)
        rb = planes[0].shape[1] * planes[0].element_size()
        outs = [torch.empty((n, planes[0].shape[1]), dtype=planes[0].dtype, device=dev)
                for _ in planes]
        pa = (P * 2)(*[x.data_ptr() for x in planes])
        oa = (P * 2)(*[o.data_ptr() for o in outs])
        want = row_gather_multi(planes, idxs[0])

        def run(design, i):
            return rows_fn(design, len(planes), pa, oa, i.data_ptr(), n, planes[0].shape[0],
                           rb, stream)

        def check(name):
            for o in outs:
                o.zero_()
            run(names[name], idxs[0])
            torch.cuda.synchronize()
            return all(torch.equal(a, b) for a, b in zip(outs, want))

        designs = [("port: a thread a vector", [lambda i=i: row_gather_multi(planes, i)
                                                for i in idxs])]
        designs += [(name, [lambda i=i, d=d: run(d, i) for i in idxs]) for name, d in names.items()]
        compare(label, designs, check)

    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    keys = [torch.randint(-(2**31), 2**31 - 1, (1 << 27,), device=dev, dtype=torch.int32,
                          generator=g) for _ in range(2)]
    gather_case("probe key pair 2 x [2^19, 256] i32, n=131072",
                [k.view(1 << 19, 256) for k in keys], 131072, 96000,
                {"a warp a row": 0, "TMA": 2})
    gather_case("planning key pair 2 x [2^20, 128] i32, n=106496",
                [k.view(1 << 20, 128) for k in keys], 106496, 35000, {"a warp a row": 0})
    del keys
    src = torch.empty((2 * 131072, 256), dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    us = float(np.median([device_us([lambda: dst.copy_(src)] * 8) for _ in range(5)][1:]))
    nbytes = src.numel() * src.element_size()
    print(f"copy_ of {nbytes / 1e6:.0f} MB, read and written: {us:.2f} us of device time, "
          f"{2 * nbytes / us / 1e6:.3f} TB/s", flush=True)
    del src, dst
    vals = torch.randn((1 << 27, 32), device=dev, generator=g)
    gather_case("values [2^27, 32] f32, n=131072", [vals], 131072, 131072,
                {"chunks": 1}, zero_frac=0.1)
    del vals
    torch.cuda.empty_cache()

    C, n, T = 1 << 27, 106496, 34941
    acc = torch.rand((C, 1), device=dev, generator=g)
    slots = []
    for _ in range(8):
        s = torch.full((n,), -1, device=dev, dtype=torch.int32)
        s[:T] = torch.randperm(C, device=dev, generator=g)[:T].to(torch.int32)
        slots.append(s)
    clamped = [s.clamp(min=0) for s in slots]
    zero = torch.zeros((n, 1), device=dev)
    out = torch.empty((n, 1), device=dev)
    old = torch.empty((n, 1), device=dev)

    def elems(mode, i):
        return elems_fn(mode, acc.data_ptr(), i.data_ptr(), zero.data_ptr(), out.data_ptr(), n,
                        C, stream)

    def check_elems(mode, idx):
        def check(_name):
            want = acc.view(-1)[idx.long().clamp(0, C - 1)].view(-1, 1)
            if mode == 2:
                want = torch.where((idx >= 0)[:, None], want, 0.0)
            elems(mode, idx)
            torch.cuda.synchronize()
            return torch.equal(out, want)
        return check

    label = "accumulator [2^27, 1] f32, n=106496, 34941 kept"
    compare(f"{label}: gather", [
        ("port: a thread a vector", [lambda i=i: row_gather_multi([acc], i) for i in clamped]),
        ("4 a thread", [lambda i=i: elems(0, i) for i in clamped])], check_elems(0, clamped[0]))
    compare(f"{label}: add", [
        ("port: a thread a vector", [lambda i=i: row_scatter_add(acc, i, zero) for i in slots]),
        ("4 a thread", [lambda i=i: elems(1, i) for i in slots])], lambda _name: True)
    compare(f"{label}: fetch-add", [
        ("port: a thread a vector", [lambda i=i: row_scatter_add(acc, i, zero, old)
                                     for i in slots]),
        ("4 a thread", [lambda i=i: elems(2, i) for i in slots])], check_elems(2, slots[0]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
