// Multi-scale deformable sampling (MSDA), backward, for Hopper (sm_90a).
//
// Two kernels' worth of work, one per TPU kernel of
// far3d_tpu/ops/msda_pallas.py:
//
//   msda_dval   replaces `msda_dval_kernel` (`_make_dval_kernel`, built by
//               `_build_dval_call`):
//                 d_value[b,row,ch] = sum w[b,q,g(ch),l,p] * bw_corner * g[b,q,ch]
//               over every (query, level, point, corner) whose corner lands
//               on `row`.
//   msda_dattn  replaces `msda_dattn_kernel` (`_make_dattn_kernel`, built by
//               `_build_dattn_call`) and the bilinear chain rule that
//               `_backward` then runs in XLA:
//                 d_weights[b,q,g,l,p] = sum_{ch in g} g[ch] * sample[ch]
//                 d_loc[b,q,p]        = sum_l sum_corner d_bw_corner * d bw / d loc
//               with sample = sum_corner bw * value[corner] and
//               d_bw_corner = sum_ch g[ch] * w[g(ch)] * value[corner, ch].
//
// The bilinear corners are those of `_corner_data` (far3d_tpu_torch/ops/
// msda.py) and of msda_fwd.cu (msda_common.cuh). A corner that is in bounds
// but has a zero bilinear weight (dx or dy exactly 0) still carries a
// location gradient, so msda_dattn tests validity, not the weight.
//
// What bounds them on an H100: bytes. Per hit corner msda_dval does one f32
// multiply-add a channel and msda_dattn two, against 2 (bf16) or 4 (f32)
// bytes of value or gradient moved: far below the ~20 FLOP/byte where the f32
// CUDA cores would limit. msda_dval must write the whole d_value (7 cameras x
// 12,750 rows x 256 channels at the production training shape) and read the
// gradient rows of the queries that hit, the weights of the points that hit
// and all of loc. msda_dattn must read the value rows that some valid corner
// touches, the same gradient rows and weights, and write all of d_weights
// (f32) and d_loc. chip_smoke.py counts these bytes from the operands of a
// full-width train step.
//
// msda_dval: a gather by value row, in a fixed order, in four steps. As in
// the forward, each hit re-reads its gradient row (and attention weights)
// from L2, so L2 traffic, several times the distinct bytes, and the stable
// sort of every corner slot set its time.
//  1. msda_dval_records (one thread per (camera, query, level, point)) writes
//     for each of the four corner slots, slot = ((b*Q + q)*L + l)*P + p)*4 +
//     corner, a key, the corner's row in its camera's value rows
//     start(l) + row, or `rows` where the bilinear weight is zero, and the
//     bilinear weight. Keys are int16 where rows fit (12,751 values at the
//     model's levels), so the sort below takes two radix passes, not four.
//  2. The wrapper sorts the keys stably in torch (ops/msda.py:dval_segments;
//     the counterpart of `_Prep`'s stable argsort, which the JAX package runs
//     in XLA outside its kernels). Slots are camera-major, so the hits of row
//     r of camera b become one run, segment r * B + b, ordered by slot.
//     msda_dval_starts finds where each segment starts.
//  3. msda_dval_reduce cuts the sorted hits into chunks of `chunk` records
//     and gives each chunk to one warp, so a row with thousands of hits is
//     spread over many warps and no warp waits on one long run. The warp
//     reads 32 records a round (slot, key; the next round's while this one
//     gathers) into shared memory, then walks them in order. Lane i owns VEC
//     consecutive channels (VEC = 8 at C = 256: a 16-byte load a lane, one
//     coalesced 512-byte gradient row a warp) and issues U gradient-row loads
//     with their records' bilinear and attention weights before using any.
//     It sums in f32 registers and, where a segment ends, writes the row
//     once in the value's type if the segment lies inside the chunk, else
//     keeps the chunk's f32 partial of it (at most two a chunk: the segment
//     it starts inside and the one it ends inside).
//  4. msda_dval_finish, one warp per value row, writes zeros for a row no
//     corner hits, and for a row that spans chunks sums its partials in
//     chunk order and writes it once.
// No float atomics, no f32 copy of d_value, no memset of it; every sum runs in an
// order fixed by the operands, so two calls give bitwise equal d_value.
//
// msda_dattn gives one warp to each (camera, query, point) and walks the
// levels. Lane i owns VEC consecutive channels (VEC = 8 for C = 256), so a
// channel group (C/G channels) is a power-of-two run of lanes and a corner
// row is one contiguous read across the warp. For each level the warp
// computes the four corners (uniform over the warp), skips the level before
// any value load when no corner is in bounds, else dots each valid corner's
// row with the gradient, reduces the attention-weight gradient over the
// group's lanes and the corner gradients over the warp with shuffles, and
// accumulates d_loc in registers. d_loc is written once per (camera, query,
// point) and d_weights once per (group, level, point): no atomics, so both
// are bitwise reproducible.

#include "msda_common.cuh"

namespace {

using msda::Corners;
using msda::corners;
using msda::Levels;
using msda::make_levels;

template <typename T> struct Pair;

template <> struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
};

template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// ---------------------------------------------------------------- msda_dval

constexpr int kWarps = 8;  // warps a block of the dval kernels

// loc (B, Q, P, 2) f32 -> keys (B*Q*L*P*4) K (int16 or int32), bw
// (B*Q*L*P*4) f32. One thread per (camera, query, level, point), item
// ((b*Q + q)*L + l)*P + p; a key is the corner's row in its camera's value
// rows, or `rows` where the bilinear weight is zero.
template <typename K>
__global__ void msda_dval_records_kernel(const float* __restrict__ loc,
                                         K* __restrict__ keys,
                                         float* __restrict__ bw, Levels lv,
                                         int items, int num_points,
                                         int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= items) return;
  const int p = i % num_points;
  const int t = i / num_points;
  const int bq = t / lv.n;
  const msda::Level lvl = msda::level(lv, t - bq * lv.n);
  const float* lq = loc + ((size_t)bq * num_points + p) * 2;
  const Corners c = corners(__ldg(lq), __ldg(lq + 1), lvl.h, lvl.w);
  K k[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    k[j] = (K)(c.w[j] != 0.f ? lvl.start + c.row[j] : rows);
  if constexpr (sizeof(K) == 2) {
    reinterpret_cast<short4*>(keys)[i] = make_short4(k[0], k[1], k[2], k[3]);
  } else {
    reinterpret_cast<int4*>(keys)[i] = make_int4(k[0], k[1], k[2], k[3]);
  }
  reinterpret_cast<float4*>(bw)[i] = make_float4(c.w[0], c.w[1], c.w[2], c.w[3]);
}

// The segment of sorted record i: row r of camera b is segment
// r * num_cams + b; the sentinel key (r = rows) maps to num_cams * rows.
__device__ __forceinline__ int segment(const void* sorted_keys, int key_bytes,
                                       const long long* order, int i,
                                       int num_cams, int slots_per_cam,
                                       int num_segs) {
  const int key = key_bytes == 2
      ? (int)__ldg(static_cast<const short*>(sorted_keys) + i)
      : __ldg(static_cast<const int*>(sorted_keys) + i);
  const int seg = key * num_cams + (int)__ldg(order + i) / slots_per_cam;
  return seg < num_segs ? seg : num_segs;
}

// starts (num_segs + 1): starts[c] = the first sorted record whose segment
// is c or later (n where there is none). Thread j in [0, n] writes the
// entries c in (segment(j - 1), segment(j)], so each is written once.
__global__ void msda_dval_starts_kernel(const void* __restrict__ sorted_keys,
                                        int key_bytes,
                                        const long long* __restrict__ order,
                                        int* __restrict__ starts, int n,
                                        int num_cams, int slots_per_cam,
                                        int num_segs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j > n) return;
  const int prev = j == 0 ? -1
      : segment(sorted_keys, key_bytes, order, j - 1, num_cams,
                slots_per_cam, num_segs);
  const int curr = j == n ? num_segs
      : segment(sorted_keys, key_bytes, order, j, num_cams, slots_per_cam,
                num_segs);
  for (int c = prev + 1; c <= curr; ++c) starts[c] = j;
}

// A segment's sum in chunk c (records [lo, lo + chunk)): written to its
// d_value row if the segment lies inside the chunk, else kept as the chunk's
// head partial (the segment began in an earlier chunk) or its tail partial
// (it goes on past it).
template <typename T, int VEC>
__device__ __forceinline__ void flush_row(int seg, const float (&acc)[VEC],
                                          const int* __restrict__ starts,
                                          int lo, int chunk, int c,
                                          int num_cams, int rows,
                                          T* __restrict__ d_value,
                                          float* __restrict__ head,
                                          float* __restrict__ tail,
                                          int channels, int ch0) {
  const int st = __ldg(starts + seg);
  const int en = __ldg(starts + seg + 1);
  if (st >= lo && en - lo <= chunk) {
    const int row = seg % num_cams * rows + seg / num_cams;
    msda::store_vec<T, VEC>(d_value + (size_t)row * channels + ch0, acc);
  } else {
    msda::store_vec<float, VEC>(
        (st < lo ? head : tail) + (size_t)c * channels + ch0, acc);
  }
}

// grad_out (B, Q, C) in T; weights (B, Q, G, L, P) f32; sorted_keys (K,
// key_bytes wide) and order (slots) from the stable sort; starts
// (num_cams * rows + 1) from msda_dval_starts_kernel; bw (slots) f32.
// One warp per chunk of `chunk` sorted records, 32 records a round: lane j
// reads record j's slot and key (the next round's while this one gathers)
// into shared memory; then the warp walks the round's records U at a time,
// each lane issuing U gradient-row loads and the U records' bilinear and
// attention weights of its group before using any. Lanes at or past C / VEC
// read records and idle in the gather.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
msda_dval_reduce_kernel(const T* __restrict__ grad_out,
                        const float* __restrict__ weights,
                        const void* __restrict__ sorted_keys,
                        int key_bytes, const long long* __restrict__ order,
                        const int* __restrict__ starts,
                        const float* __restrict__ bw, T* __restrict__ d_value,
                        float* __restrict__ head, float* __restrict__ tail,
                        int num_cams, int rows, int chunk, int num_chunks,
                        int num_query, int num_levels, int num_points,
                        int num_groups, int channels) {
  constexpr int N = msda::words<T, VEC>();
  constexpr int U = 64 / N < 16 ? 64 / N : 16;   // rows in flight a lane
  __shared__ int rec[kWarps][4][32];       // segment, slot, b*Q + q, l*P + p
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + warp;
  const int hits = __ldg(starts + num_cams * rows);
  const int lo = c * chunk;                // num_chunks * chunk < 2^31
  if (c >= num_chunks || lo >= hits) return;   // uniform over the warp
  const int hi = hits - lo < chunk ? hits : lo + chunk;
  const int lp_n = num_levels * num_points;
  int* seg_s = rec[warp][0];
  int* slot_s = rec[warp][1];
  int* bq_s = rec[warp][2];
  int* lp_s = rec[warp][3];

  const int ch0 = lane * VEC;
  const bool active = ch0 < channels;
  const float* wg = weights + (active ? ch0 / (channels / num_groups) : 0) * lp_n;
  const T* gb = grad_out + ch0;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  int cur = -1;                            // the segment being summed
  const short* keys16 = static_cast<const short*>(sorted_keys);
  const int* keys32 = static_cast<const int*>(sorted_keys);
  int next_slot = 0, next_key = 0;
  if (lo + lane < hi) {
    next_slot = (int)__ldg(order + lo + lane);
    next_key = key_bytes == 2 ? __ldg(keys16 + lo + lane)
                              : __ldg(keys32 + lo + lane);
  }
  for (int base = lo; base < hi; base += 32) {
    const int slot = next_slot;
    const int pt = slot >> 2;              // ((b*Q + q)*L + l)*P + p
    const int bq = pt / lp_n;
    seg_s[lane] = next_key * num_cams + bq / num_query;
    slot_s[lane] = slot;
    bq_s[lane] = bq;
    lp_s[lane] = pt - bq * lp_n;
    if (base + 32 + lane < hi) {           // the next round's records
      next_slot = (int)__ldg(order + base + 32 + lane);
      next_key = key_bytes == 2 ? __ldg(keys16 + base + 32 + lane)
                                : __ldg(keys32 + base + 32 + lane);
    }
    __syncwarp();
    const int n = hi - base < 32 ? hi - base : 32;
    for (int r0 = 0; r0 < n; r0 += U) {
      unsigned vals[U][N];
      float coef[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u;
        if (r < n && active) {
          const int q = bq_s[r];
          msda::load_words(gb + (size_t)q * channels, vals[u]);
          coef[u] = __ldg(bw + slot_s[r]) *
                    __ldg(wg + (size_t)q * num_groups * lp_n + lp_s[r]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u;
        if (r < n) {
          const int seg = seg_s[r];
          if (seg != cur) {                // uniform over the warp
            if (cur >= 0 && active)
              flush_row<T, VEC>(cur, acc, starts, lo, chunk, c, num_cams,
                                rows, d_value, head, tail, channels, ch0);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
            cur = seg;
          }
          if (active) msda::fma_words<T, VEC>(acc, coef[u], vals[u]);
        }
      }
    }
    __syncwarp();
  }
  if (active)
    flush_row<T, VEC>(cur, acc, starts, lo, chunk, c, num_cams, rows, d_value,
                      head, tail, channels, ch0);
}

// One warp per segment (value row): zeros where no corner hits the row; for
// a segment that spans chunks c0 < c1, tail[c0] + head[c0 + 1] + ... +
// head[c1] in that order; segments inside one chunk were written by
// msda_dval_reduce_kernel.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
msda_dval_finish_kernel(const int* __restrict__ starts,
                        const float* __restrict__ head,
                        const float* __restrict__ tail,
                        T* __restrict__ d_value, int num_cams, int rows,
                        int chunk, int channels) {
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int ch0 = lane * VEC;
  if (seg >= num_cams * rows || ch0 >= channels) return;
  const int row = seg % num_cams * rows + seg / num_cams;
  const int st = __ldg(starts + seg);
  const int en = __ldg(starts + seg + 1);
  float acc[VEC];
  if (st == en) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  } else {
    const int c0 = st / chunk;
    const int c1 = (en - 1) / chunk;
    if (c0 == c1) return;
    msda::load_vec<float, VEC>(tail + (size_t)c0 * channels + ch0, acc);
    for (int c = c0 + 1; c <= c1; ++c) {
      float part[VEC];
      msda::load_vec<float, VEC>(head + (size_t)c * channels + ch0, part);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += part[e];
    }
  }
  msda::store_vec<T, VEC>(d_value + (size_t)row * channels + ch0, acc);
}

template <typename T>
int launch_dval(int vec, int num_chunks, cudaStream_t s, const void* grad_out,
                const float* weights, const void* sorted_keys, int key_bytes,
                const long long* order, const int* starts, const float* bw,
                void* d_value, float* head, float* tail, int num_cams,
                int rows, int chunk, int num_query, int num_levels,
                int num_points, int num_groups, int channels) {
  const T* g = static_cast<const T*>(grad_out);
  T* d = static_cast<T*>(d_value);
  const unsigned reduce_blocks = (num_chunks + kWarps - 1) / kWarps;
  const unsigned finish_blocks = (num_cams * rows + kWarps - 1) / kWarps;
#define MSDA_DVAL_CASE(N)                                                     \
  case N:                                                                     \
    if (num_chunks > 0) {                                                     \
      msda_dval_reduce_kernel<T, N><<<reduce_blocks, kWarps * 32, 0, s>>>(    \
          g, weights, sorted_keys, key_bytes, order, starts, bw, d, head,     \
          tail, num_cams, rows, chunk, num_chunks, num_query, num_levels,     \
          num_points, num_groups, channels);                                  \
      const cudaError_t err = cudaGetLastError();                             \
      if (err != cudaSuccess) return (int)err;                                \
    }                                                                         \
    msda_dval_finish_kernel<T, N><<<finish_blocks, kWarps * 32, 0, s>>>(     \
        starts, head, tail, d, num_cams, rows, chunk, channels);              \
    break;
  switch (vec) {
    MSDA_DVAL_CASE(2)
    MSDA_DVAL_CASE(4)
    MSDA_DVAL_CASE(8)
    MSDA_DVAL_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MSDA_DVAL_CASE
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- msda_dattn

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; k += 2) {
    const float2 v = Pair<T>::load(p + k);
    out[k] = v.x;
    out[k + 1] = v.y;
  }
}

// value (B, rows, C) and grad_out (B, Q, C) in T; loc (B, Q, P, 2) f32;
// weights (B, Q, G, L, P) f32 -> d_loc (B, Q, P, 2) f32 and
// d_weights (B, Q, G, L, P) f32, every element written.
// Block (32, warps per block); one warp per (b, q, p); lane i owns channels
// [i*VEC, i*VEC + VEC), lanes at or past C/VEC idle but join the shuffles.
template <typename T, int VEC>
__global__ void msda_dattn_kernel(const T* __restrict__ value,
                                  const T* __restrict__ grad_out,
                                  const float* __restrict__ loc,
                                  const float* __restrict__ weights,
                                  float* __restrict__ d_loc,
                                  float* __restrict__ d_weights, Levels lv,
                                  long long num_items, int num_query,
                                  int num_points, int num_groups,
                                  int channels, int rows) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  const long long item = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (item >= num_items) return;               // uniform over the warp
  const int p = (int)(item % num_points);
  const long long bq = item / num_points;      // b * Q + q
  const int b = (int)(bq / num_query);
  const int ch0 = lane * VEC;
  const bool active = ch0 < channels;
  const int group_ch = channels / num_groups;
  const int group_lanes = group_ch / VEC;      // a power of two
  const int g = active ? ch0 / group_ch : 0;

  float go[VEC];
  if (active) {
    load_vec<T, VEC>(grad_out + bq * channels + ch0, go);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) go[k] = 0.f;
  }
  const float u = __ldg(loc + (bq * num_points + p) * 2);
  const float v = __ldg(loc + (bq * num_points + p) * 2 + 1);
  const float* wq = weights + (bq * num_groups + g) * lv.n * num_points + p;
  float* dwq = d_weights + (bq * num_groups + g) * lv.n * num_points + p;
  const T* vb = value + (size_t)b * rows * channels + ch0;

  float dlx = 0.f, dly = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const Corners c = corners(u, v, lv.h[l], lv.w[l]);
    float dw = 0.f;
    if (c.valid[0] || c.valid[1] || c.valid[2] || c.valid[3]) {
      const T* vl = vb + (size_t)lv.start[l] * channels;
      float t[4];                              // g . value[corner] over my channels
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        t[k] = 0.f;
        if (c.valid[k] && active) {
          float val[VEC];
          load_vec<T, VEC>(vl + (size_t)c.row[k] * channels, val);
#pragma unroll
          for (int e = 0; e < VEC; ++e) t[k] = fmaf(go[e], val[e], t[k]);
        }
      }
      const float a = active ? __ldg(wq + l * num_points) : 0.f;
      dw = c.w[0] * t[0] + c.w[1] * t[1] + c.w[2] * t[2] + c.w[3] * t[3];
      // d bw / d dx and d dy of the four corners (zero where invalid: t = 0)
      const float ddx = a * ((1.f - c.dy) * (t[1] - t[0]) + c.dy * (t[3] - t[2]));
      const float ddy = a * ((1.f - c.dx) * (t[2] - t[0]) + c.dx * (t[3] - t[1]));
      for (int off = 1; off < group_lanes; off <<= 1)
        dw += __shfl_xor_sync(full, dw, off);
      float sx = ddx, sy = ddy;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sx += __shfl_xor_sync(full, sx, off);
        sy += __shfl_xor_sync(full, sy, off);
      }
      dlx += sx * (float)lv.w[l];              // d dx / d u = W
      dly += sy * (float)lv.h[l];              // d dy / d v = H
    }
    if (active && (lane % group_lanes) == 0) dwq[l * num_points] = dw;
  }
  if (lane == 0) {
    *reinterpret_cast<float2*>(d_loc + (bq * num_points + p) * 2) =
        make_float2(dlx, dly);
  }
}

template <typename T>
int launch_dattn(int vec, dim3 grid, dim3 block, cudaStream_t s,
                 const void* value, const void* grad_out, const float* loc,
                 const float* weights, float* d_loc, float* d_weights,
                 const Levels& lv, long long items, int num_query,
                 int num_points, int num_groups, int channels, int rows) {
  const T* v = static_cast<const T*>(value);
  const T* g = static_cast<const T*>(grad_out);
#define MSDA_DATTN_CASE(N)                                                    \
  case N:                                                                     \
    msda_dattn_kernel<T, N><<<grid, block, 0, s>>>(                           \
        v, g, loc, weights, d_loc, d_weights, lv, items, num_query,           \
        num_points, num_groups, channels, rows);                              \
    break;
  switch (vec) {
    MSDA_DATTN_CASE(2)
    MSDA_DATTN_CASE(4)
    MSDA_DATTN_CASE(8)
    MSDA_DATTN_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MSDA_DATTN_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. Pointers are device pointers from torch's data_ptr();
// level_hw is a host array of num_levels (H, W) int pairs; stream is a
// cudaStream_t. Each returns the first CUDA error (0 = success), checking
// cudaGetLastError() after every launch. The caller has checked shapes,
// types, contiguity and alignment (value-typed tensors to
// min(16, vec * sizeof(T)) bytes).

// keys (B*Q*L*P*4) int16 (key_bytes 2) or int32 (4) and bw (B*Q*L*P*4)
// f32, every slot written; int16 keys need rows <= 32767.
extern "C" int msda_dval_records(const void* loc, void* keys, void* bw,
                                 int key_bytes, int batch, int num_query,
                                 int num_points, int num_levels,
                                 const void* level_hw, int rows,
                                 void* stream) {
  Levels lv;
  if (!make_levels(num_levels, level_hw, rows, &lv) ||
      (key_bytes != 2 && key_bytes != 4) || (key_bytes == 2 && rows > 32767))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)batch * num_query * num_levels * num_points;
  if (items == 0) return 0;
  if (4 * items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((items + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(loc);
  float* b = static_cast<float*>(bw);
  if (key_bytes == 2) {
    msda_dval_records_kernel<short><<<blocks, threads, 0, s>>>(
        l, static_cast<short*>(keys), b, lv, (int)items, num_points, rows);
  } else {
    msda_dval_records_kernel<int><<<blocks, threads, 0, s>>>(
        l, static_cast<int*>(keys), b, lv, (int)items, num_points, rows);
  }
  return (int)cudaGetLastError();
}

// From the stably sorted keys and their slots (order, int64): starts
// (B * rows + 1) int32 scratch, then d_value (B, rows, C) in the value's
// type, every element written; partials (2, ceil(B*Q*L*P*4 / chunk), C) f32
// scratch (head, then tail partials); vec as for msda_dattn but without the
// power-of-two condition; chunk a positive multiple of 32.
extern "C" int msda_dval_reduce(const void* grad_out, const void* weights,
                                const void* sorted_keys, const void* order,
                                const void* bw, void* starts, void* d_value,
                                void* partials, int value_is_bf16,
                                int key_bytes, int vec, int batch,
                                int num_query, int num_points, int num_groups,
                                int channels, int num_levels, int rows,
                                int chunk, void* stream) {
  if (vec < 2 || channels % vec != 0 || channels / vec > 32 ||
      (channels / num_groups) % vec != 0 || chunk < 32 || chunk % 32 != 0 ||
      num_levels < 1 || (key_bytes != 2 && key_bytes != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long slots =
      (long long)batch * num_query * num_levels * num_points * 4;
  if (slots + chunk > 0x7fffffffLL ||
      ((long long)rows + 1) * batch > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* o = static_cast<const long long*>(order);
  int* st = static_cast<int*>(starts);
  const int num_segs = batch * rows;
  const int threads = 256;
  msda_dval_starts_kernel<<<(unsigned)(slots / threads + 1), threads, 0, s>>>(
      sorted_keys, key_bytes, o, st, (int)slots, batch,
      (int)(slots / batch), num_segs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int num_chunks = (int)((slots + chunk - 1) / chunk);
  float* head = static_cast<float*>(partials);
  float* tail = head + (size_t)num_chunks * channels;
  const float* w = static_cast<const float*>(weights);
  const float* b = static_cast<const float*>(bw);
  if (value_is_bf16) {
    return launch_dval<__nv_bfloat16>(
        vec, num_chunks, s, grad_out, w, sorted_keys, key_bytes, o, st, b,
        d_value, head, tail, batch, rows, chunk, num_query, num_levels,
        num_points, num_groups, channels);
  }
  return launch_dval<float>(
      vec, num_chunks, s, grad_out, w, sorted_keys, key_bytes, o, st, b,
      d_value, head, tail, batch, rows, chunk, num_query, num_levels,
      num_points, num_groups, channels);
}

// d_loc (B, Q, P, 2) f32 and d_weights (B, Q, G, L, P) f32; vec is the
// channels a lane owns (2, 4, 8 or 16; C / vec <= 32 and (C / G) / vec a
// power of two).
extern "C" int msda_dattn(const void* value, const void* grad_out,
                          const void* loc, const void* weights, void* d_loc,
                          void* d_weights, int value_is_bf16, int vec,
                          int batch, int num_query, int num_points,
                          int num_groups, int channels, int num_levels,
                          const void* level_hw, int rows, void* stream) {
  Levels lv;
  if (!make_levels(num_levels, level_hw, rows, &lv) || vec < 2 ||
      channels % vec != 0 || channels / vec > 32 ||
      (channels / num_groups) % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int group_lanes = channels / num_groups / vec;
  if (group_lanes < 1 || (group_lanes & (group_lanes - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long items = (long long)batch * num_query * num_points;
  if (items == 0) return 0;
  const int warps = 8;
  dim3 block(32, warps);
  dim3 grid((unsigned)((items + warps - 1) / warps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(loc);
  const float* w = static_cast<const float*>(weights);
  float* dl = static_cast<float*>(d_loc);
  float* dw = static_cast<float*>(d_weights);
  if (value_is_bf16) {
    return launch_dattn<__nv_bfloat16>(vec, grid, block, s, value, grad_out,
                                       l, w, dl, dw, lv, items, num_query,
                                       num_points, num_groups, channels, rows);
  }
  return launch_dattn<float>(vec, grid, block, s, value, grad_out, l, w, dl,
                             dw, lv, items, num_query, num_points, num_groups,
                             channels, rows);
}
