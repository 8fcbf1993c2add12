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
// msda_dattn (replaces `msda_dattn_kernel` and `_backward`'s chain rule, as
// above) is bound by bytes too, but what it reads is far more than its
// bound counts: every valid corner re-reads a C-wide value row from L2
// (516,051 rows, about 264 MB a call at the training shape, against the
// 45 MB of distinct rows, weights, loc and outputs), so the rate at which
// L2 feeds the SMs sets its time. A block of kDattnWarps warps takes
// kDattnPairs consecutive (camera, query) pairs, in three steps:
//  1. A thread per (pair, point) computes the corners of every level and
//     tests validity, not weight (see above). The points with a valid
//     corner are listed in shared memory with their valid corners (4 bits a
//     level), and per level the first corner's row and dx, dy. A point
//     without one, most of them (78% of the pairs at the training shape
//     have none), reads its loc and nothing else: no gradient row, weight
//     or value row.
//  2. Warps take the listed points. Lane i owns VEC consecutive channels
//     (VEC = 8 at C = 256, G = 8: a 16-byte load a lane, a 512-byte row a
//     warp; a group is a power-of-two run of lanes). A warp starts the
//     loads of the gradient row, the attention weights of the levels with
//     a valid corner and every valid corner row of LR levels before it uses
//     any: two levels a round in bf16 at 16 bytes a lane (up to 8 rows in
//     flight a lane), one in f32 at VEC = 8. It then dots each row with the
//     gradient over its channels and folds the corners into the lane's
//     d_weights partial per level and its d_loc partial; group shuffles
//     reduce d_weights once a round, a full-warp reduction reduces d_loc
//     once a point. Two rounds, not one: with all four levels' rows in
//     flight a thread needs about 128 registers and a SM holds 16 warps; at
//     64 it holds 32, which hides more of the L2 latency (PERF.md §6).
//     At VEC = 16 in f32 one level's rows pass the 64 registers and spill;
//     the model's shapes do not take that path.
//  3. The block's d_weights (pairs x G*L*P f32, zero for every point
//     without a hit) and d_loc are staged in shared memory and written as
//     whole lines.
// Compared with a warp per (camera, query, point) walking the levels, a
// warp waits on two rounds of loads, not five dependent ones, rows
// move as 16-byte words, d_weights is not stored 4 bytes at a time, and a
// point without a hit costs a few instructions of a thread, not a warp
// reading a gradient row. Each valid corner still reads its row from L2.
// No float atomics; each point is summed by one warp in a fixed order, so
// two calls give bitwise equal d_loc and d_weights.

#include "msda_common.cuh"

namespace {

using msda::Corners;
using msda::corners;
using msda::Levels;
using msda::make_levels;

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

constexpr int kDattnWarps = 8;  // warps a block of msda_dattn
// (camera, query) pairs a block of msda_dattn takes (fewer where their
// shared memory would pass 48 KB): its threads test their points' corners,
// its warps share the points that hit.
constexpr int kDattnPairs = 4;
// __launch_bounds__' minimum: 4 blocks of 256 threads cap a thread at 64
// registers, so a SM holds 32 warps
constexpr int kDattnBlocksPerSm = 4;
// 4-byte words of value rows a lane holds in flight: 32 is the corner rows
// of two levels in bf16 at 16 bytes a lane, so four levels take two rounds
constexpr int kDattnLoadWords = 32;

// Shared-memory words of a block of msda_dattn over `pairs` pairs of
// num_points points and num_levels levels: d_weights (pairs * G*L*P), d_loc
// (pairs * P * 2), and the list of points with a valid corner: the point,
// its valid corners (bit 4 * l + k) and, per level, the first corner's row
// and dx, dy (pairs * P * (2 + 3 * L)); and the list's length.
__host__ __device__ inline int dattn_words(int pairs, int glp, int num_points,
                                           int num_levels) {
  return pairs * (glp + num_points * (4 + 3 * num_levels)) + 1;
}

// g . row over a lane's VEC channels (both as words of T), one fmaf a
// channel in order.
template <typename T, int VEC>
__device__ __forceinline__ float dot_words(
    const unsigned (&g)[msda::words<T, VEC>()],
    const unsigned (&u)[msda::words<T, VEC>()]) {
  float t = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      const float2 a = msda::unpack_bf16x2(g[k]);
      const float2 b = msda::unpack_bf16x2(u[k]);
      t = fmaf(a.x, b.x, t);
      t = fmaf(a.y, b.y, t);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      t = fmaf(__uint_as_float(g[k]), __uint_as_float(u[k]), t);
  }
  return t;
}

// value (B, rows, C) and grad_out (B, Q, C) in T; loc (B, Q, P, 2) f32;
// weights (B, Q, G, L, P) f32 -> d_loc (B, Q, P, 2) f32 and d_weights
// (B, Q, G, L, P) f32, every element written. Block kDattnWarps * 32
// threads over pairs [blockIdx.x * pairs_per_block, + pairs_per_block) of
// the num_pairs = B * Q; lanes at or past C / VEC join the shuffles with
// zeros.
template <typename T, int VEC>
__global__ void __launch_bounds__(kDattnWarps * 32, kDattnBlocksPerSm)
msda_dattn_kernel(const T* __restrict__ value, const T* __restrict__ grad_out,
                  const float* __restrict__ loc,
                  const float* __restrict__ weights, float* __restrict__ d_loc,
                  float* __restrict__ d_weights, Levels lv, int num_pairs,
                  int pairs_per_block, int num_query, int num_points,
                  int num_groups, int channels, int rows) {
  constexpr int N = msda::words<T, VEC>();
  // levels whose corner rows a lane holds in one round
  constexpr int LR = kDattnLoadWords / (4 * N) < 1 ? 1
      : (kDattnLoadWords / (4 * N) > 4 ? 4 : kDattnLoadWords / (4 * N));
  const unsigned full = 0xffffffffu;
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int np = num_points;
  const int glp = num_groups * lv.n * np;
  const int pair0 = blockIdx.x * pairs_per_block;
  const int pairs = min(pairs_per_block, num_pairs - pair0);
  const int pts = pairs * np;
  const int cap = pairs_per_block * np;           // list entries
  float* dw_s = reinterpret_cast<float*>(smem);
  float* dl_s = dw_s + pairs_per_block * glp;
  int* list_t = reinterpret_cast<int*>(dl_s + cap * 2);
  unsigned* list_valid = reinterpret_cast<unsigned*>(list_t + cap);
  int* list_row = reinterpret_cast<int*>(list_valid + cap);   // [l][entry]
  float* list_dx = reinterpret_cast<float*>(list_row + lv.n * cap);
  float* list_dy = list_dx + lv.n * cap;
  int* count = reinterpret_cast<int*>(list_dy + lv.n * cap);

  // 1. a thread per (pair, point): the corners of every level; the points
  // with a valid corner are listed with their corners
  if (tid == 0) *count = 0;
  for (int i = tid; i < pts * 2; i += blockDim.x) dl_s[i] = 0.f;
  for (int i = tid; i < pairs * glp; i += blockDim.x) dw_s[i] = 0.f;
  __syncthreads();
  for (int base = 0; base < pts; base += blockDim.x) {   // uniform
    const int t = base + tid;
    unsigned valid = 0;
    int row[MSDA_MAX_LEVELS];
    float dx[MSDA_MAX_LEVELS], dy[MSDA_MAX_LEVELS];
    if (t < pts) {
      const float2 uv = __ldg(reinterpret_cast<const float2*>(loc) +
                              pair0 * np + t);
#pragma unroll
      for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
        if (l < lv.n) {
          const Corners c = corners(uv.x, uv.y, lv.h[l], lv.w[l]);
#pragma unroll
          for (int k = 0; k < 4; ++k) valid |= (unsigned)c.valid[k] << (4 * l + k);
          row[l] = lv.start[l] + c.row[0];
          dx[l] = c.dx;
          dy[l] = c.dy;
        }
      }
    }
    const unsigned hit = __ballot_sync(full, valid != 0);
    int slot = 0;
    if (lane == 0 && hit) slot = atomicAdd(count, __popc(hit));
    slot = __shfl_sync(full, slot, 0) + __popc(hit & ((1u << lane) - 1u));
    if (valid) {
      list_t[slot] = t;
      list_valid[slot] = valid;
#pragma unroll
      for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
        if (l < lv.n) {
          list_row[l * cap + slot] = row[l];
          list_dx[l * cap + slot] = dx[l];
          list_dy[l * cap + slot] = dy[l];
        }
      }
    }
  }
  __syncthreads();

  // 2. a warp per listed point
  const int n = *count;
  const int ch0 = lane * VEC;
  const bool active = ch0 < channels;
  const int group_ch = channels / num_groups;
  const int group_lanes = group_ch / VEC;        // a power of two
  const int g = active ? ch0 / group_ch : 0;
  for (int i = warp; i < n; i += kDattnWarps) {
    const int t = list_t[i];
    // the valid corners this lane loads: none where it holds no channel
    const unsigned valid = active ? list_valid[i] : 0u;
    const int j = t / np;
    const int p = t - j * np;
    const int bq = pair0 + j;
    const T* vb = value + (size_t)(bq / num_query) * rows * channels + ch0;
    const float* wq = weights + (size_t)(bq * num_groups + g) * lv.n * np + p;
    unsigned gw[N];
    if (active) msda::load_words(grad_out + (size_t)bq * channels + ch0, gw);
    float dlx = 0.f, dly = 0.f;
#pragma unroll
    for (int l0 = 0; l0 < MSDA_MAX_LEVELS; l0 += LR) {
      if (l0 >= lv.n) break;                      // uniform over the warp
      unsigned vals[LR][4][N];
      float a[LR];
#pragma unroll
      for (int r = 0; r < LR; ++r) {              // start every load
        const int l = l0 + r;
        a[r] = 0.f;
        if (valid >> (4 * l) & 0xfu) {            // l < L: no bits past it
          a[r] = __ldg(wq + l * np);
          const int row0 = list_row[l * cap + i];
          const int row[4] = {row0, row0 + 1, row0 + lv.w[l], row0 + lv.w[l] + 1};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (valid >> (4 * l + k) & 1u)
              msda::load_words(vb + (size_t)row[k] * channels, vals[r][k]);
          }
        }
      }
      float dw[LR];
#pragma unroll
      for (int r = 0; r < LR; ++r) {              // then use them
        const int l = l0 + r;
        dw[r] = 0.f;
        if (valid >> (4 * l) & 0xfu) {
          const float dx = list_dx[l * cap + i], dy = list_dy[l * cap + i];
          float tk[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            tk[k] = valid >> (4 * l + k) & 1u
                        ? dot_words<T, VEC>(gw, vals[r][k]) : 0.f;
          }
          // the bilinear weights as corners() computes them
          const float ex = 1.f - dx, ey = 1.f - dy;
          dw[r] = (valid >> (4 * l) & 1u ? ey * ex : 0.f) * tk[0] +
                  (valid >> (4 * l + 1) & 1u ? ey * dx : 0.f) * tk[1] +
                  (valid >> (4 * l + 2) & 1u ? dy * ex : 0.f) * tk[2] +
                  (valid >> (4 * l + 3) & 1u ? dy * dx : 0.f) * tk[3];
          // d bw / d dx and d dy of the four corners (tk = 0 where invalid),
          // times d dx / d u = W and d dy / d v = H
          const float ddx = a[r] * (ey * (tk[1] - tk[0]) + dy * (tk[3] - tk[2]));
          const float ddy = a[r] * (ex * (tk[2] - tk[0]) + dx * (tk[3] - tk[1]));
          dlx += ddx * (float)lv.w[l];
          dly += ddy * (float)lv.h[l];
        }
      }
#pragma unroll
      for (int r = 0; r < LR; ++r) {
        for (int off = 1; off < group_lanes; off <<= 1)
          dw[r] += __shfl_xor_sync(full, dw[r], off);
      }
      if (active && (lane & (group_lanes - 1)) == 0) {
#pragma unroll
        for (int r = 0; r < LR; ++r) {
          const int l = l0 + r;
          if (l < lv.n) dw_s[j * glp + (g * lv.n + l) * np + p] = dw[r];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dlx += __shfl_xor_sync(full, dlx, off);
      dly += __shfl_xor_sync(full, dly, off);
    }
    if (lane == 0) {
      dl_s[2 * t] = dlx;
      dl_s[2 * t + 1] = dly;
    }
  }
  __syncthreads();

  // 3. the block's d_weights and d_loc as whole lines
  float* dwo = d_weights + (size_t)pair0 * glp;
  for (int i = tid; i < pairs * glp; i += blockDim.x) dwo[i] = dw_s[i];
  float* dlo = d_loc + (size_t)pair0 * np * 2;
  for (int i = tid; i < pts * 2; i += blockDim.x) dlo[i] = dl_s[i];
}

template <typename T>
int launch_dattn(int vec, dim3 grid, size_t smem, cudaStream_t s,
                 const void* value, const void* grad_out, const float* loc,
                 const float* weights, float* d_loc, float* d_weights,
                 const Levels& lv, int num_pairs, int pairs_per_block,
                 int num_query, int num_points, int num_groups, int channels,
                 int rows) {
  const T* v = static_cast<const T*>(value);
  const T* g = static_cast<const T*>(grad_out);
#define MSDA_DATTN_CASE(N)                                                    \
  case N:                                                                     \
    msda_dattn_kernel<T, N><<<grid, kDattnWarps * 32, smem, s>>>(             \
        v, g, loc, weights, d_loc, d_weights, lv, num_pairs, pairs_per_block, \
        num_query, num_points, num_groups, channels, rows);                   \
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
// power of two); refused where one pair's shared memory would pass 48 KB.
extern "C" int msda_dattn(const void* value, const void* grad_out,
                          const void* loc, const void* weights, void* d_loc,
                          void* d_weights, int value_is_bf16, int vec,
                          int batch, int num_query, int num_points,
                          int num_groups, int channels, int num_levels,
                          const void* level_hw, int rows, void* stream) {
  Levels lv;
  if (!make_levels(num_levels, level_hw, rows, &lv) || vec < 2 ||
      channels % vec != 0 || channels / vec > 32 || num_groups < 1 ||
      (channels / num_groups) % vec != 0 || num_points < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int group_lanes = channels / num_groups / vec;
  if (group_lanes < 1 || (group_lanes & (group_lanes - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long pairs = (long long)batch * num_query;
  const long long glp = (long long)num_groups * num_levels * num_points;
  if (pairs * glp > 0x7fffffffLL || pairs * num_points * 2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (pairs == 0) return 0;
  const int max_words = 48 * 1024 / (int)sizeof(int);
  int per_block = kDattnPairs;
  while (per_block > 1 && dattn_words(per_block, (int)glp, num_points, num_levels) > max_words)
    --per_block;
  if (dattn_words(per_block, (int)glp, num_points, num_levels) > max_words)
    return (int)cudaErrorInvalidValue;
  const size_t smem = dattn_words(per_block, (int)glp, num_points, num_levels) * sizeof(int);
  dim3 grid((unsigned)((pairs + per_block - 1) / per_block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(loc);
  const float* w = static_cast<const float*>(weights);
  float* dl = static_cast<float*>(d_loc);
  float* dw = static_cast<float*>(d_weights);
  if (value_is_bf16) {
    return launch_dattn<__nv_bfloat16>(vec, grid, smem, s, value, grad_out, l,
                                       w, dl, dw, lv, (int)pairs, per_block,
                                       num_query, num_points, num_groups,
                                       channels, rows);
  }
  return launch_dattn<float>(vec, grid, smem, s, value, grad_out, l, w, dl, dw,
                             lv, (int)pairs, per_block, num_query, num_points,
                             num_groups, channels, rows);
}
