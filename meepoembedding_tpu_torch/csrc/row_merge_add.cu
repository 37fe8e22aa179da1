// Row merge-add, the port of K1. Two entries:
//
//   meepo_row_add_unique  plane[vrow[j]] += upd[j] in place, for an [R, W]
//                         plane of f32 or bf16 and [m, W] f32 updates, the
//                         rows in [0, R) unique (every values-plane update
//                         of the training path): no sort, one thread per
//                         16-byte vector of a row.
//   meepo_segment_sum     out[vrow[j]] += upd[j] into an [R, W] f32 output
//                         that starts at zero, duplicates summed (the
//                         gradient of a gather by vrow), the rows given
//                         sorted: their stable sort `skey` and its
//                         permutation `order`. A memset zeroes the output,
//                         then two kernels (below) write each run's sum.
//
// Rows outside [0, R) are dropped. Replaces the TPU kernel `_kernel` (K1,
// meepoembedding_tpu/table/stream_merge.py:61, entry `stream_merge_add`
// :524, dispatched by `values_scatter_add` :562). K1 streamed the touched
// 2048-row blocks of the plane through VMEM and merged the sorted updates
// into each block as a one-hot matmul on the MXU, so duplicates summed there.
//
// Bound: device memory. The unique add moves 4 bytes of index and 4 * W of
// update per position, and reads and writes each valid row once. The
// segment sum moves 12 bytes of keys and order and 4 * W of update per
// position, and writes each touched row once. The adds are m * W
// operations, far below the card's rate.
//
// Arithmetic: the sum runs in f32 from the old row (from 0 in the segment
// sum) through the updates in input order, and is rounded once to the
// plane's type. A row seen once gets old + upd rounded once.
//
// Design of the segment sum, for a card whose blocks run in no order (no
// block-by-block carry as on the TPU) and whose longest run (a hot id, ~800
// updates a step) must not be one warp's chain: the m sorted positions are
// cut into fixed segments of kSeg positions (a multiple of 32), one warp per
// segment. A warp walks its positions in chunks of 32, each lane holding one
// column: the chunk's keys and order arrive one chunk ahead, a ballot marks
// the positions that start a run, all 32 update rows are loaded before any
// add, then one select and one add a position give each position its run's
// sum so far, and one predicated store a run writes the sums of the runs
// that end in the chunk. A run that touches at most two segments (every run
// of at most kSeg updates) belongs to the warp of the segment where it
// starts, which walks on into the next segment to its end: its sum is the
// input-order sum, exactly. A run that touches three or more segments
// leaves one partial per segment in scratch (`part_tail` of its first
// segment, `part_head` of the others), and the combine pass adds them in
// segment order with one warp per such run. Every decision reads only the
// sorted keys at segment boundaries, so both passes agree on it, and the
// result is the same bits on every launch. Offsets are 64-bit.
// Per position the walk does no branch: a walk that branched on every key
// was bound by its dependent instructions, not by memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 64;
constexpr unsigned kAll = 0xffffffffu;
// positions a warp of the segment sum walks; timed on the card at 32-256,
// fastest at 64 (PERF.md)
constexpr int kSeg = 64;
static_assert(kSeg % 32 == 0, "a segment is whole chunks of 32 positions");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

long long grid_for(long long items, int per_block) {
  long long b = (items + per_block - 1) / per_block;
  return b > kMaxBlocks ? kMaxBlocks : (b < 1 ? 1 : b);
}

// --- unique rows ---------------------------------------------------------------

// Four columns a thread: a 16-byte load of updates, the plane's 4 elements.
struct alignas(8) Bf16x4 { __nv_bfloat16 v[4]; };

__device__ __forceinline__ float4 load4(const float* p) { return *(const float4*)p; }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const Bf16x4 b = *(const Bf16x4*)p;
  return make_float4(__bfloat162float(b.v[0]), __bfloat162float(b.v[1]),
                     __bfloat162float(b.v[2]), __bfloat162float(b.v[3]));
}
__device__ __forceinline__ void store4(float* p, float4 x) { *(float4*)p = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  Bf16x4 b;
  b.v[0] = __float2bfloat16_rn(x.x);
  b.v[1] = __float2bfloat16_rn(x.y);
  b.v[2] = __float2bfloat16_rn(x.z);
  b.v[3] = __float2bfloat16_rn(x.w);
  *(Bf16x4*)p = b;
}

template <typename T>
__global__ void add_unique_vec4_kernel(T* __restrict__ plane,
                                       const int32_t* __restrict__ vrow,
                                       const float* __restrict__ upd, long long m,
                                       long long rows, int width) {
  const int vpr = width >> 2;
  const long long total = m * vpr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long j = e / vpr;
    const long long r = __ldg(vrow + j);
    if (r < 0 || r >= rows) continue;  // dropped: nothing but the index read
    const int c = (int)(e - j * vpr) << 2;
    T* p = plane + r * width + c;
    const float4 u = __ldg((const float4*)(upd + j * width + c));
    float4 a = load4(p);
    a.x += u.x;
    a.y += u.y;
    a.z += u.z;
    a.w += u.w;
    store4(p, a);
  }
}

template <typename T>
__global__ void add_unique_kernel(T* __restrict__ plane, const int32_t* __restrict__ vrow,
                                  const float* __restrict__ upd, long long m,
                                  long long rows, int width) {
  const long long total = m * width;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long j = e / width;
    const long long r = __ldg(vrow + j);
    if (r < 0 || r >= rows) continue;
    const int c = (int)(e - j * width);
    T* p = plane + r * width + c;
    store(p, to_f32(*p) + __ldg(upd + e));
  }
}

template <typename T>
void launch_unique(void* plane, const void* vrow, const void* upd, long long m,
                   long long rows, int width, cudaStream_t s) {
  const uintptr_t align = sizeof(T) * 4;
  const bool vec = width % 4 == 0 && (uintptr_t)plane % align == 0 &&
                   (uintptr_t)upd % 16 == 0;
  if (vec) {
    add_unique_vec4_kernel<T><<<(unsigned)grid_for(m * (width / 4), kThreads), kThreads, 0, s>>>(
        (T*)plane, (const int32_t*)vrow, (const float*)upd, m, rows, width);
  } else {
    add_unique_kernel<T><<<(unsigned)grid_for(m * width, kThreads), kThreads, 0, s>>>(
        (T*)plane, (const int32_t*)vrow, (const float*)upd, m, rows, width);
  }
}

// --- the segment sum: fixed segments, then the long runs' partials ---------------

struct Seg {
  long long m, rows;
  int width;
};

// Where a finished piece of a run goes: the output, part_head, or nowhere
// (the piece belongs to the run of the warp before).
enum Dest { kOut, kHead, kNone };

// A load that the compiler may not move past a store: the chunk's 32 loads
// stay together, in flight at once.
__device__ __forceinline__ float load_pinned(const float* p) {
  float x;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(x) : "l"(p) : "memory");
  return x;
}

__device__ __forceinline__ void write_row(float* out, const Seg& a, int32_t r, int c, bool on,
                                          float acc) {
  if (!on || r < 0 || (long long)r >= a.rows) return;
  out[(long long)r * a.width + c] = acc;
}

// A finished piece: to the output, to part_head[g], or nowhere.
__device__ __forceinline__ void finish(float* out, float* part_head, const Seg& a, long long g,
                                       Dest dest, int32_t r, int c, bool on, float acc) {
  if (dest == kOut) write_row(out, a, r, c, on, acc);
  else if (dest == kHead && on) part_head[g * a.width + c] = acc;
}

__global__ void segment_walk_kernel(float* __restrict__ out, const int32_t* __restrict__ skey,
                                    const int64_t* __restrict__ order,
                                    const float* __restrict__ upd, float* __restrict__ part_head,
                                    float* __restrict__ part_tail, Seg a) {
  const int lane = threadIdx.x & 31;
  const long long S = kSeg, m = a.m;
  const long long nseg = (m + S - 1) / S;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); g < nseg;
       g += nwarps) {
    // a walk covers at most [s0, s2): its segment and, for a run that
    // touches two segments, the next one
    const long long s0 = g * S, s1 = min(s0 + S, m), s2 = min(s1 + S, m);
    // every key the warp's decisions read, and its first chunk's keys and
    // order, loaded at once
    const int32_t first = __ldg(skey + s0);
    const int32_t at_before = s0 > 0 ? __ldg(skey + s0 - 1) : 0;
    const int32_t at_before_prev = s0 - S > 0 ? __ldg(skey + s0 - S - 1) : 0;
    const int32_t at_s1 = s1 < m ? __ldg(skey + s1) : 0;
    const int32_t at_s2 = s2 < m ? __ldg(skey + s2) : 0;
    const int32_t key_first = s0 + lane < s2 ? __ldg(skey + s0 + lane) : 0;
    const long long ord_first = s0 + lane < s2 ? __ldg(order + s0 + lane) : 0;
    // the piece at s0, when its run started in an earlier segment: a run
    // that touches only g - 1 and g is the earlier warp's (skipped here);
    // a longer one leaves its piece in part_head[g]
    Dest head = kOut;
    if (s0 > 0 && at_before == first) {
      const bool before_prev = s0 - S > 0 && at_before_prev == first;
      const bool after = s1 < m && at_s1 == first;
      head = (before_prev || after) ? kHead : kNone;
    }
    for (int c0 = 0; c0 < a.width; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < a.width;
      // the open piece: its row, where it goes, its sum so far
      int32_t cur = first;
      Dest dest = head;
      float acc = 0.0f;
      long long lim = s1;
      bool extended = false;
      int32_t key = key_first;  // the chunk at k0: lane l holds position k0 + l
      long long ord = ord_first;
      for (long long k0 = s0;; k0 += 32) {
        if (k0 >= lim) {
          // the open piece reached the walk's end (lim is s1 until extended)
          if (!extended && dest != kNone && lim < m && at_s1 == cur) {
            if (dest == kHead) {
              if (on) part_head[g * a.width + c] = acc;
              break;
            }
            if (s2 < m && at_s2 == cur) {  // touches 3+ segments
              if (on) part_tail[g * a.width + c] = acc;
              break;
            }
            extended = true;  // touches 2: walk on to the run's end
            lim = s2;
          } else {
            finish(out, part_head, a, g, dest, cur, c, on, acc);
            break;
          }
        }
        // the next chunk's keys and order, in flight while this one is summed
        const long long nk = k0 + 32 + lane;
        const int32_t next_key = nk < s2 ? __ldg(skey + nk) : 0;
        const long long next_ord = nk < s2 ? __ldg(order + nk) : 0;
        // the chunk's positions: up to lim, and in an extended walk only
        // those of the run (a prefix: the keys are sorted)
        int cnt = (int)min(32LL, lim - k0);
        if (extended) {
          const unsigned same = __ballot_sync(kAll, lane < cnt && key == cur);
          cnt = same == kAll ? 32 : __ffs(~same) - 1;
        }
        // positions that start a piece (their key differs from the one
        // before); a start at 0 closes the piece open since the last chunk
        const int32_t up = __shfl_up_sync(kAll, key, 1);
        const unsigned starts = __ballot_sync(kAll, lane < cnt && key != (lane ? up : cur));
        if (starts & 1u) {
          finish(out, part_head, a, g, dest, cur, c, on, acc);
          dest = kOut;
        }
        // only the updates this warp sums are read: not those of the run of
        // the warp before
        const bool need = lane < cnt && (dest != kNone || key != cur);
        const long long src = need ? ord : 0;
        // all 32 loads issued here, before the adds and their stores (the
        // pinned load keeps the compiler from sinking each one to its add,
        // which would wait on them one by one); positions not needed and
        // columns past the row read row 0, column 0 (cached), unused
        float v[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const long long srct = __shfl_sync(kAll, src, t);
          v[t] = load_pinned(upd + srct * a.width + (on ? c : 0));
        }
        // the running sums, in input order: v[t] becomes the sum of its
        // piece through position t (a select and an add a position)
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const float base = ((starts >> t) & 1u) ? 0.0f : acc;
          if (t < cnt) acc = base + v[t];
          v[t] = acc;
        }
        // each piece that ends inside the chunk (before the next start): the
        // first goes where the open piece went, the others to the output
        const unsigned valid = cnt == 32 ? kAll : (1u << cnt) - 1u;
        const unsigned ends = (starts >> 1) & (valid >> 1);
        const int fe = __ffs(ends) - 1;
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const int32_t kt = __shfl_sync(kAll, key, t);
          const bool end = (ends >> t) & 1u;
          const bool to_out = end && (t != fe || dest == kOut);
          if (to_out && on && kt >= 0 && (long long)kt < a.rows) {
            out[(long long)kt * a.width + c] = v[t];
          }
          if (end && t == fe && dest == kHead && on) part_head[g * a.width + c] = v[t];
        }
        if (ends) dest = kOut;
        if (cnt > 0) cur = __shfl_sync(kAll, key, cnt - 1);
        if (extended && cnt < 32) {  // the extended run ended in this chunk
          write_row(out, a, cur, c, on, acc);
          break;
        }
        key = next_key;
        ord = next_ord;
      }
    }
  }
}

// One warp per segment whose last run touches three or more segments: the
// run's partials in segment order, then one write.
__global__ void segment_combine_kernel(float* __restrict__ out, const int32_t* __restrict__ skey,
                                       const float* __restrict__ part_head,
                                       const float* __restrict__ part_tail, Seg a) {
  const int lane = threadIdx.x & 31;
  const long long S = kSeg, m = a.m;
  const long long nseg = (m + S - 1) / S;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); g < nseg;
       g += nwarps) {
    const long long s0 = g * S, s1 = min(s0 + S, m);
    if (s1 + S >= m) continue;  // no third segment to reach
    const int32_t cur = __ldg(skey + s1 - 1);
    if (__ldg(skey + s1) != cur || __ldg(skey + s1 + S) != cur) continue;
    if (s0 > 0 && __ldg(skey + s0 - 1) == cur) continue;  // started earlier
    // the last segment h of the run: the first whose end is past it
    long long h_end = -1;
    for (long long h0 = g + 1; h_end < 0; h0 += 32) {
      const long long h = h0 + lane;
      const long long e = min((h + 1) * S, m);
      const bool ends = h >= nseg - 1 || __ldg(skey + e) != cur;
      const unsigned b = __ballot_sync(kAll, ends);
      if (b) h_end = h0 + __ffs(b) - 1;
    }
    for (int c0 = 0; c0 < a.width; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < a.width;
      float acc = on ? part_tail[g * a.width + c] : 0.0f;
      for (long long h0 = g + 1; h0 <= h_end; h0 += 32) {
        // 32 partials in flight, then the adds in segment order
        float v[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          v[t] = load_pinned(part_head + min(h0 + t, h_end) * a.width + (on ? c : 0));
        }
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          if (h0 + t <= h_end) acc += v[t];
        }
      }
      write_row(out, a, cur, c, on, acc);
    }
  }
}

}  // namespace

// vrow: m row indices, unique among those in [0, rows); the others are
// dropped. is_bf16: 1 for a bf16 plane, 0 for f32.
extern "C" int meepo_row_add_unique(void* plane, const void* vrow, const void* upd,
                                    long long m, long long rows, long long width,
                                    int is_bf16, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    launch_unique<__nv_bfloat16>(plane, vrow, upd, m, rows, (int)width, s);
  } else {
    launch_unique<float>(plane, vrow, upd, m, rows, (int)width, s);
  }
  return (int)cudaGetLastError();
}

// The positions a warp of the segment sum walks: its scratch holds
// 2 * ceil(m / meepo_segment_size()) * width f32.
extern "C" int meepo_segment_size() { return kSeg; }

// out: [rows, width] f32; skey: the m row indices sorted ascending; order:
// each sorted position's index into upd [m, width]; scratch: f32, of the
// size above. Zeroes out (a memset: the rows no run reaches, most of an
// output padded to the batch, must read zero) and writes each run's sum:
// the walk, then the combine pass.
extern "C" int meepo_segment_sum(void* out, const void* skey, const void* order,
                                 const void* upd, void* scratch, long long m, long long rows,
                                 long long width, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)rows * (size_t)width * 4, s);
  if (err != cudaSuccess || m <= 0) return (int)err;
  const Seg a{m, rows, (int)width};
  const long long nseg = (m + kSeg - 1) / kSeg;
  float* part_head = (float*)scratch;
  float* part_tail = part_head + nseg * width;
  const unsigned blocks = (unsigned)grid_for(nseg, kWarps);
  segment_walk_kernel<<<blocks, kThreads, 0, s>>>(
      (float*)out, (const int32_t*)skey, (const int64_t*)order, (const float*)upd, part_head,
      part_tail, a);
  segment_combine_kernel<<<blocks, kThreads, 0, s>>>(
      (float*)out, (const int32_t*)skey, part_head, part_tail, a);
  return (int)cudaGetLastError();
}

extern "C" const char* meepo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
