// Row gather from up to kMaxPlanes planes that share one index vector:
// out_p[j] = plane_p[clamp(idx[j], 0, R - 1)] for [R, W] planes of one shape
// and one element size (2 or 4 bytes).
//
// Replaces the TPU kernel `_gather_kernel` (K2, meepoembedding_tpu/table/
// pallas_ops.py:58, entry point `row_gather` :110), which kept 256 row DMAs
// in flight per grid step. It carries every table read of both paths: the
// probe's key-pair rows (key_hi and key_lo, [nb/2, 256] int32, one launch for
// both), insert planning's bucket rows ([nb, 128] int32, the same pair), the
// found rows of the values plane ([capacity, dim] f32 or bf16), the batch
// rows by the dedup's inverse, and the full-dim optimizer state.
//
// Bound: device memory. The work is n rows read and written per plane and 4n
// bytes of indices; the least time is (4n + 2 k n row_bytes) / 3.35 TB/s on
// an H100 SXM, less where indices repeat (a repeated row is read once). A
// scattered 4-byte row still moves a whole 32-byte sector, so for the flat
// [R, 1] views the reachable bound is the sector bound.
//
// Design: one thread per vector of the widest width (16 bytes for every
// path's rows but the flat views' 4) that the row and every pointer allow,
// its index loaded per vector (an L1 hit after the row's first), the vector
// of every plane loaded before any store, so the K planes of a launch share
// each index load and keep K loads in flight a thread. Neighbouring threads
// read neighbouring vectors of a row, and the grid has a thread for every
// vector, so the block scheduler balances the load, also where repeated
// indices make some rows cache hits (a batch's padding). Each shape-specific
// design tried against it measured slower on an H100 (PERF.md): a warp a
// row for 512 B and 1 KB rows, shuffled 32-row chunks for 128 B rows, four
// indices a thread for 4-byte rows, and TMA bulk copies through shared
// memory. Offsets are 64-bit: a flat view holds 2^31 elements. Nothing is
// shared between threads, so no shared memory; plane reads go through the
// read-only path (`__ldg`), since the kernel never writes the planes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 4;
constexpr int kThreads = 256;

}  // namespace

// The planes of one launch; mirrored by a ctypes.Structure in
// kernels/row_gather.py.
struct GatherPlanes {
  const void* plane[kMaxPlanes];
  void* out[kMaxPlanes];  // [n, W] each, the plane's type
  int k;                  // planes in use
};

namespace {

struct alignas(16) Vec16 { uint4 v; };
struct alignas(8) Vec8 { uint2 v; };

__device__ __forceinline__ long long clamp_row(long long r, long long rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

// a read-only load of one vector
__device__ __forceinline__ Vec16 load(const Vec16* p) { return Vec16{__ldg(&p->v)}; }
__device__ __forceinline__ Vec8 load(const Vec8* p) { return Vec8{__ldg(&p->v)}; }
__device__ __forceinline__ uint32_t load(const uint32_t* p) { return __ldg(p); }
__device__ __forceinline__ uint16_t load(const uint16_t* p) { return __ldg(p); }

long long blocks_for(long long threads, int per_block, long long cap) {
  const long long b = (threads + per_block - 1) / per_block;
  return b > cap ? cap : b;
}

// One thread per V-sized vector of an output row, the vectors of all K
// planes loaded before any store.
template <typename V, int K>
__global__ void row_gather_vecs(const GatherPlanes gp, const int32_t* __restrict__ idx,
                                long long n, long long rows, int vecs_per_row) {
  const V* src[K];
  V* dst[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    src[p] = (const V*)gp.plane[p];
    dst[p] = (V*)gp.out[p];
  }
  const long long total = n * vecs_per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long j = vecs_per_row == 1 ? e : e / vecs_per_row;
    const long long from = clamp_row(__ldg(idx + j), rows) * vecs_per_row + (e - j * vecs_per_row);
    V v[K];
#pragma unroll
    for (int p = 0; p < K; ++p) v[p] = load(src[p] + from);
#pragma unroll
    for (int p = 0; p < K; ++p) dst[p][e] = v[p];
  }
}

template <typename V>
void launch_vecs(const GatherPlanes& gp, const void* idx, long long n, long long rows,
                 long long row_bytes, cudaStream_t s) {
  const int vpr = (int)(row_bytes / (long long)sizeof(V));
  // a thread per vector: the block scheduler balances the rows
  const unsigned blocks = (unsigned)blocks_for(n * vpr, kThreads, 1LL << 30);
  const int32_t* i = (const int32_t*)idx;
  switch (gp.k) {
    case 1: row_gather_vecs<V, 1><<<blocks, kThreads, 0, s>>>(gp, i, n, rows, vpr); break;
    case 2: row_gather_vecs<V, 2><<<blocks, kThreads, 0, s>>>(gp, i, n, rows, vpr); break;
    case 3: row_gather_vecs<V, 3><<<blocks, kThreads, 0, s>>>(gp, i, n, rows, vpr); break;
    default: row_gather_vecs<V, 4><<<blocks, kThreads, 0, s>>>(gp, i, n, rows, vpr); break;
  }
}

}  // namespace

// Every plane is [rows, row_bytes / elem] of one element size (2 or 4 bytes);
// each out[p] is [n, same].
extern "C" int meepo_row_gather(const GatherPlanes* planes, const void* idx, long long n,
                                long long rows, long long row_bytes, void* stream) {
  if (n <= 0 || planes->k <= 0) return 0;
  if (planes->k > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const GatherPlanes& gp = *planes;
  cudaStream_t s = (cudaStream_t)stream;
  uintptr_t addr = 0;
  for (int p = 0; p < gp.k; ++p) addr |= (uintptr_t)gp.plane[p] | (uintptr_t)gp.out[p];
  int vec = 16;
  while (vec > 2 && ((row_bytes % vec) != 0 || (addr % vec) != 0)) vec >>= 1;
  switch (vec) {
    case 16: launch_vecs<Vec16>(gp, idx, n, rows, row_bytes, s); break;
    case 8: launch_vecs<Vec8>(gp, idx, n, rows, row_bytes, s); break;
    case 4: launch_vecs<uint32_t>(gp, idx, n, rows, row_bytes, s); break;
    default: launch_vecs<uint16_t>(gp, idx, n, rows, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
