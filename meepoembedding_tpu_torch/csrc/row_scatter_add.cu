// Row add, in place: plane[idx[j]] += upd[j] for an [R, W] plane of int32
// (wrapping add) or f32, with unique idx. Rows with idx outside [0, R) are
// dropped. With `old` given, the same launch also writes each kept row's
// value from before the add to old[j], and 0 to the rows it drops: a
// fetch-add.
//
// Replaces the TPU kernel `_scatter_add_kernel` (K3, meepoembedding_tpu/
// table/pallas_ops.py:187, body :124-184, entry `row_scatter_add` :253),
// which pipelined one row DMA in and one out per index through two VMEM
// slabs: it read the rows anyway, and the fetch-add hands them back. K3
// clipped idx >= R onto row R - 1 (:130, :138); its callers mean "drop"
// (`mode="drop"`, xla_ops.py:411-412), and so does this kernel. On the
// training path it carries the bucket-plane adds: the rowwise accumulator
// (f32, a fetch-add: rowwise AdaGrad needs the old sum) and, when a policy
// keeps scores, freq (int32). Those planes are [nb, 128]; the callers pass
// the flat [nb * 128, 1] view with idx = slot, so each add is one element.
//
// Bound: device memory. The least traffic is the indices (4n bytes), the
// updates read once, the touched elements read once and written once
// (3 * n * W * 4 bytes), and n * W * 4 bytes of `old`. One element per index
// (W = 1) makes every plane access a scattered 4-byte load or store, each in
// a 32-byte sector of its own, so the device moves more than the bytes
// counted; the sector bound is the one to hold it against. The accumulator's
// add is a few microseconds, mostly launch and two dependent round trips
// (the index, then the element).
//
// Design: one thread per vector of the widest width the row and every
// pointer allow (one element on the flat views), as the row gather: a
// thread for every vector, its index loaded per vector. The fetch-add reads
// the element once and stores the sum and the old value, so rowwise AdaGrad
// pays one launch and one scattered read where it paid two of each. Four
// indices a thread (one int4 load, four plane loads before the stores)
// measured slower on an H100 (PERF.md). The plane is read with plain loads,
// not the read-only path, since this kernel writes it. Indices are unique,
// so no two threads touch one element and no atomics are needed: the result
// is the same bits on every launch. Offsets are 64-bit (flat views of 2^31
// elements).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 30;  // a thread per vector: the block scheduler balances

long long blocks_for(long long threads, int per_block, long long cap) {
  const long long b = (threads + per_block - 1) / per_block;
  return b > cap ? cap : b;
}

__device__ __forceinline__ bool kept(long long r, long long rows) { return r >= 0 && r < rows; }

// one 4-byte lane: f32 add, or int32 add modulo 2^32 (unsigned, no UB)
template <bool kFloat>
__device__ __forceinline__ uint32_t add4(uint32_t a, uint32_t b) {
  if (kFloat) return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  return a + b;
}

template <bool kFloat>
__device__ __forceinline__ uint32_t add_vec(uint32_t a, uint32_t b) {
  return add4<kFloat>(a, b);
}
template <bool kFloat>
__device__ __forceinline__ uint2 add_vec(uint2 a, uint2 b) {
  return make_uint2(add4<kFloat>(a.x, b.x), add4<kFloat>(a.y, b.y));
}
template <bool kFloat>
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b) {
  return make_uint4(add4<kFloat>(a.x, b.x), add4<kFloat>(a.y, b.y),
                    add4<kFloat>(a.z, b.z), add4<kFloat>(a.w, b.w));
}

// One thread per V-sized vector of a row; `old` is null unless kOld.
template <typename V, bool kFloat, bool kOld>
__global__ void row_add_vecs(V* __restrict__ plane, const int32_t* __restrict__ idx,
                             const V* __restrict__ upd, V* __restrict__ old, long long n,
                             long long rows, int vecs_per_row) {
  const long long total = n * vecs_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long j = vecs_per_row == 1 ? e : e / vecs_per_row;
    const long long r = __ldg(idx + j);
    if (!kept(r, rows)) {
      if (kOld) old[e] = V{};
      continue;
    }
    V* dst = plane + r * vecs_per_row + (e - j * vecs_per_row);
    const V a = *dst;
    *dst = add_vec<kFloat>(a, upd[e]);
    if (kOld) old[e] = a;
  }
}

template <bool kFloat, bool kOld>
void dispatch(void* plane, const void* idx, const void* upd, void* old, long long n,
              long long rows, long long row_bytes, cudaStream_t s) {
  const uintptr_t addr = (uintptr_t)plane | (uintptr_t)upd | (uintptr_t)old;
  int vec = 16;
  while (vec > 4 && ((row_bytes % vec) != 0 || (addr % vec) != 0)) vec >>= 1;
  const int vpr = (int)(row_bytes / vec);
  const unsigned blocks = (unsigned)blocks_for(n * vpr, kThreads, kMaxBlocks);
  switch (vec) {
    case 16:
      row_add_vecs<uint4, kFloat, kOld><<<blocks, kThreads, 0, s>>>(
          (uint4*)plane, (const int32_t*)idx, (const uint4*)upd, (uint4*)old, n, rows, vpr);
      break;
    case 8:
      row_add_vecs<uint2, kFloat, kOld><<<blocks, kThreads, 0, s>>>(
          (uint2*)plane, (const int32_t*)idx, (const uint2*)upd, (uint2*)old, n, rows, vpr);
      break;
    default:
      row_add_vecs<uint32_t, kFloat, kOld><<<blocks, kThreads, 0, s>>>(
          (uint32_t*)plane, (const int32_t*)idx, (const uint32_t*)upd, (uint32_t*)old, n,
          rows, vpr);
      break;
  }
}

}  // namespace

// is_float: 1 for an f32 plane, 0 for int32. old: [n, width] of the plane's
// type, or null for the plain add.
extern "C" int meepo_row_scatter_add(void* plane, const void* idx, const void* upd, void* old,
                                     long long n, long long rows, long long width,
                                     int is_float, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = width * 4;
  if (is_float) {
    if (old) dispatch<true, true>(plane, idx, upd, old, n, rows, row_bytes, s);
    else dispatch<true, false>(plane, idx, upd, old, n, rows, row_bytes, s);
  } else {
    if (old) dispatch<false, true>(plane, idx, upd, old, n, rows, row_bytes, s);
    else dispatch<false, false>(plane, idx, upd, old, n, rows, row_bytes, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
