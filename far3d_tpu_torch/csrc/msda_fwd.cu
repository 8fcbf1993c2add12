// Multi-scale deformable sampling (MSDA), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `msda_fwd_kernel` (far3d_tpu/ops/msda_pallas.py,
// built by `_make_kernel` / `_build_call`). It computes, for each camera b,
// query q and channel ch,
//
//   out[b,q,ch] = sum_level sum_point sum_corner
//                 w[b,q,ch/(C/G),level,point] * bw_corner * value[b,row(corner),ch]
//
// with the bilinear corners of `_corner_data` (far3d_tpu_torch/ops/msda.py):
// x = u*W - 0.5, y = v*H - 0.5, each out-of-bounds corner weighted zero.
//
// What bounds it on an H100: bytes. Per hit corner it reads one C-wide row
// and does C multiply-adds, about 1 FLOP per byte of bf16 gathered, far below
// the ~20 FLOP/byte where the f32 CUDA cores would become the limit. The least
// traffic is the value rows that some hit corner reads, the weights of the
// points that hit, all of loc, and the output written once; chip_smoke.py
// counts these bytes from the operands of both main paths.
//
// The gather reads a row once for each hit corner that lands on it, and
// rows that several queries hit are read again from L2: its traffic from L2
// to the SMs is the hits times the row width, several times the distinct
// bytes above, so L2 bandwidth and the latency of each warp's dependent
// loads, more than device memory, set its time.
//
// Design. One warp per (camera, query), in two phases.
//  - Prologue: each lane computes the corners of one (level, point) pair per
//    round (two rounds for 52 pairs). A warp prefix count compacts the hit
//    corners (bilinear weight not zero) into a list in shared memory, in
//    (level, point, corner) order: value row, bilinear weight,
//    level * P + point. A query with no hit, most of them, writes zeros and
//    leaves before reading any weight.
//  - Gather: lane i owns VEC consecutive channels (VEC = 8 at C = 256, so a
//    bf16 row is one 16-byte load a lane and 512 bytes across the warp). The
//    warp walks the list U records at a time (U = 16 in bf16): it issues the
//    U row loads and the U attention-weight loads of the lane's group
//    (w[b,q,g,l,p], only those of the points that hit) before using any,
//    then accumulates w * bw * row in f32 registers. The output is written
//    once in the value's type. The summation order is fixed, so two runs are
//    bitwise equal.
// The hit list is not saved for the backward: msda_dval walks hits by value
// row and msda_dattn by point, so neither could read a per-query list, and
// writing it would cost more bytes than recomputing the corners.

#include "msda_common.cuh"

namespace {

using msda::Corners;
using msda::Levels;

constexpr int kWarps = 8;  // (camera, query) pairs a block

// Shared-memory words of one warp: three arrays of up to 4*L*P hit records
// (value row, bilinear weight, level*P + point).
__host__ __device__ inline int warp_words(int lp) { return 12 * lp; }

// value (B, rows, C); loc (B, Q, P, 2) f32; weights (B, Q, G, L, P) f32;
// out (B, Q, C). One warp per item b * Q + q; lanes at or past C / VEC join
// the prologue and idle in the gather.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ weights, T* __restrict__ out,
                Levels lv, int items, int num_query, int num_points,
                int num_groups, int channels, int rows) {
  constexpr int N = msda::words<T, VEC>();
  constexpr int U = 64 / N < 16 ? 64 / N : 16;   // rows in flight a lane
  const unsigned full = 0xffffffffu;
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bq = blockIdx.x * (blockDim.x >> 5) + warp;
  if (bq >= items) return;                 // uniform over the warp
  const int lp_n = lv.n * num_points;
  int* rec_row = smem + warp * warp_words(lp_n);
  float* rec_bw = reinterpret_cast<float*>(rec_row + 4 * lp_n);
  int* rec_lp = rec_row + 8 * lp_n;

  const float* lq = loc + (size_t)bq * num_points * 2;
  int n = 0;                               // hit corners listed so far
  for (int base = 0; base < lp_n; base += 32) {
    const int pair = base + lane;
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    int crow[4] = {0, 0, 0, 0};
    int cnt = 0;
    if (pair < lp_n) {
      const int l = pair / num_points;
      const int p = pair - l * num_points;
      const msda::Level lvl = msda::level(lv, l);
      const Corners c = msda::corners(__ldg(lq + 2 * p), __ldg(lq + 2 * p + 1),
                                      lvl.h, lvl.w);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cw[k] = c.w[k];
        crow[k] = lvl.start + c.row[k];
        cnt += c.w[k] != 0.f;
      }
    }
    int incl = cnt;                        // inclusive prefix over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += t;
    }
    int slot = n + incl - cnt;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (cw[k] != 0.f) {
        rec_row[slot] = crow[k];
        rec_bw[slot] = cw[k];
        rec_lp[slot] = pair;
        ++slot;
      }
    }
    n += __shfl_sync(full, incl, 31);
  }
  __syncwarp();

  const int ch0 = lane * VEC;
  if (ch0 >= channels) return;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  const float* wg = weights + ((size_t)bq * num_groups +
                               ch0 / (channels / num_groups)) * lp_n;
  const T* vb = value + (size_t)(bq / num_query) * rows * channels + ch0;
  for (int r0 = 0; r0 < n; r0 += U) {
    unsigned vals[U][N];
    float coef[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u;
      if (r < n) {
        msda::load_words(vb + (size_t)rec_row[r] * channels, vals[u]);
        coef[u] = __ldg(wg + rec_lp[r]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u;
      if (r < n) msda::fma_words<T, VEC>(acc, coef[u] * rec_bw[r], vals[u]);
    }
  }
  msda::store_vec<T, VEC>(out + (size_t)bq * channels + ch0, acc);
}

template <typename T>
int launch(int vec, dim3 grid, dim3 block, size_t smem, cudaStream_t s,
           const void* value, const float* loc, const float* weights,
           void* out, const Levels& lv, int items, int num_query,
           int num_points, int num_groups, int channels, int rows) {
  const T* v = static_cast<const T*>(value);
  T* o = static_cast<T*>(out);
#define MSDA_FWD_CASE(N)                                                      \
  case N:                                                                     \
    msda_fwd_kernel<T, N><<<grid, block, smem, s>>>(                          \
        v, loc, weights, o, lv, items, num_query, num_points, num_groups,     \
        channels, rows);                                                      \
    break;
  switch (vec) {
    MSDA_FWD_CASE(2)
    MSDA_FWD_CASE(4)
    MSDA_FWD_CASE(8)
    MSDA_FWD_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MSDA_FWD_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. Pointers are device pointers from torch's data_ptr();
// level_hw is a host array of num_levels (H, W) int pairs; stream is a
// cudaStream_t; vec is the channels a lane owns (2, 4, 8 or 16, C / vec <= 32,
// (C / G) % vec == 0). Returns cudaGetLastError() after the launch
// (0 = success). The caller has checked shapes, types, contiguity and the
// alignment of value and out to min(16, vec * sizeof(T)) bytes.
extern "C" int msda_fwd(const void* value, const void* loc, const void* weights,
                        void* out, int value_is_bf16, int vec, int batch,
                        int num_query, int num_points, int num_groups,
                        int channels, int num_levels, const void* level_hw,
                        int rows, void* stream) {
  Levels lv;
  if (!msda::make_levels(num_levels, level_hw, rows, &lv) || vec < 2 ||
      channels % vec != 0 || channels / vec > 32 ||
      (channels / num_groups) % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long items = (long long)batch * num_query;
  if (items == 0) return 0;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t per_warp = warp_words(num_levels * num_points) * sizeof(int);
  const int warps = (int)(48 * 1024 / per_warp < kWarps ? 48 * 1024 / per_warp
                                                        : kWarps);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  dim3 block(32 * warps);
  dim3 grid((unsigned)((items + warps - 1) / warps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(loc);
  const float* w = static_cast<const float*>(weights);
  if (value_is_bf16) {
    return launch<__nv_bfloat16>(vec, grid, block, warps * per_warp, s, value,
                                 l, w, out, lv, (int)items, num_query, num_points,
                                 num_groups, channels, rows);
  }
  return launch<float>(vec, grid, block, warps * per_warp, s, value, l, w, out,
                       lv, (int)items, num_query, num_points, num_groups, channels,
                       rows);
}
