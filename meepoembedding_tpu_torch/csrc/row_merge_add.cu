// Row merge-add, in place: plane[vrow[j]] += upd[j] for an [R, W] plane of
// f32 or bf16 and f32 updates. Duplicate rows are summed; rows outside
// [0, R) are dropped.
//
// Replaces the TPU kernel `_kernel` (K1, meepoembedding_tpu/table/
// stream_merge.py:61, entry `stream_merge_add` :524, dispatched by
// `values_scatter_add` :562). K1 streamed the touched 2048-row blocks of the
// plane through VMEM and merged the sorted updates into each block as a
// one-hot matmul on the MXU, so duplicates summed there. On the training
// path it carries every values-plane update (unique rows: the optimizer's
// delta plus the fresh rows' init) and the gradient's segment sum (the
// backward of the gather by the dedup inverse: n rows into a zeroed
// [U, dim] plane, with as many duplicates as the batch repeats ids).
//
// Bound: device memory. The least traffic is the sorted keys and order
// (12 bytes an update), the updates read once (4 * W bytes each), and each
// touched row read once and written once. The adds are m * W operations,
// far below the card's rate.
//
// Design, for a card whose blocks run in no order (no block-by-block
// carry as on the TPU): the wrapper sorts the rows stably (`torch.sort`),
// so equal rows form runs in the order of the input. One warp per run: a
// warp whose position starts a run walks it in chunks of 32 keys (one
// coalesced load of keys and order per chunk, then the chunk's update rows,
// all 32 loads in flight before the adds), each lane holding one column.
// The sum starts from the old row, adds the updates in sorted order in f32,
// rounds once to the plane's type and writes the row once. No atomics: the same inputs give the same bits
// on every launch, and a row that appears once gets old + upd rounded once.
// Warps at positions inside a run exit at once. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void merge_add_kernel(T* __restrict__ plane,
                                 const int32_t* __restrict__ skey,
                                 const int64_t* __restrict__ order,
                                 const float* __restrict__ upd, long long m,
                                 long long rows, int width) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); s < m;
       s += nwarps) {
    const int32_t r = __ldg(skey + s);
    if (r < 0 || (long long)r >= rows) continue;  // dropped (sorted to an end)
    if (s > 0 && __ldg(skey + s - 1) == r) continue;  // inside a run
    T* row = plane + (long long)r * width;
    for (int c0 = 0; c0 < width; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < width;
      float acc = on ? to_f32(row[c]) : 0.0f;
      for (long long k0 = s;; k0 += 32) {
        // one chunk of the run: lane l holds position k0 + l
        const long long k = k0 + lane;
        const bool in_run = k < m && __ldg(skey + k) == r;
        const long long src = in_run ? __ldg(order + k) : 0;
        const unsigned mask = __ballot_sync(0xffffffffu, in_run);
        const int cnt = __popc(mask);  // sorted: the run is a prefix of the chunk
        if (cnt == 1) {  // a row seen once (every row of the values update)
          const long long src0 = __shfl_sync(0xffffffffu, src, 0);
          if (on) acc += __ldg(upd + src0 * width + c);
          break;
        }
        // all of the chunk's loads first (32 in flight), then the adds in order
        float v[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const long long srct = __shfl_sync(0xffffffffu, src, t);
          v[t] = (on && t < cnt) ? __ldg(upd + srct * width + c) : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          if (t < cnt) acc += v[t];
        }
        if (cnt < 32) break;
      }
      if (on) store(row + c, acc);
    }
  }
}

template <typename T>
void launch(void* plane, const void* skey, const void* order, const void* upd,
            long long m, long long rows, int width, cudaStream_t s) {
  long long blocks = (m + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;  // grid-stride beyond this
  merge_add_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      (T*)plane, (const int32_t*)skey, (const int64_t*)order, (const float*)upd,
      m, rows, width);
}

}  // namespace

// skey: the m row indices sorted ascending (stable); rows outside [0, rows)
// are dropped. order: each sorted position's index into upd [m, width].
// is_bf16: 1 for a bf16 plane, 0 for f32.
extern "C" int meepo_row_merge_add(void* plane, const void* skey,
                                   const void* order, const void* upd,
                                   long long m, long long rows, long long width,
                                   int is_bf16, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    launch<__nv_bfloat16>(plane, skey, order, upd, m, rows, (int)width, s);
  } else {
    launch<float>(plane, skey, order, upd, m, rows, (int)width, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
