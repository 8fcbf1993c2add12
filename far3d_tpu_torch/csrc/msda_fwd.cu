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
// What bounds it on an H100: bytes. Per query and (level, point) it reads four
// C-wide rows and does 2*C multiply-adds per row, about 1 FLOP per byte of
// bf16 gathered, far below the ~20 FLOP/byte where the f32 CUDA cores would
// become the limit. The least traffic is the value rows that some hit corner
// reads, the weights of the points that hit, all of loc, and the output
// written once. At production shape (7 cameras, 12,750 value rows of 256 bf16
// channels, 1,156 queries, 13 points, 8 groups, 4 levels) that is at most
// about 64 MB (~19 us at 3.35 TB/s) when every point hits; points that miss
// the map need none of their rows or weights, so chip_smoke.py counts the
// bytes its inputs need.
//
// Design. The TPU kernel is a tiled one-hot matmul only because Mosaic has no
// vectorized gather from VMEM; Hopper gathers natively, so this is a direct
// gather. One thread row (blockDim.x = C/2 threads) owns one query; each
// thread owns two adjacent channels, so a corner load is one contiguous
// C*sizeof(T) row across the thread row (512 bytes for C=256 in bf16), read
// as bf16x2 / float2 words. Every thread of a row computes the same corners
// from the query's location (a broadcast load), so the branches that skip a
// (level, point) whose four corner weights are all zero, and each zero
// corner, are uniform across the row: a point that projects outside the
// camera, the common case, costs no value traffic. Accumulation is f32 in
// registers; the output is written once in the value's type. Nothing is kept
// in shared memory and no block synchronizes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];  // first row of the level in the value array
  int n;
};

template <typename T> struct Pair;

template <> struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
  }
};

template <typename T>
__device__ __forceinline__ void add_corner(float2& acc, const T* level_value,
                                           int row, int channels, float wgt) {
  const float2 v = Pair<T>::load(level_value + (size_t)row * channels);
  acc.x = fmaf(wgt, v.x, acc.x);
  acc.y = fmaf(wgt, v.y, acc.y);
}

// value (B, rows, C); loc (B, Q, P, 2) f32; weights (B, Q, G, L, P) f32;
// out (B, Q, C). Grid (ceil(Q / blockDim.y), B); block (C/2, queries per block).
template <typename T>
__global__ void msda_fwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ weights,
                                T* __restrict__ out, Levels lv, int num_query,
                                int num_points, int num_groups, int channels,
                                int rows) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.y + threadIdx.y;
  if (q >= num_query) return;
  const int ch = threadIdx.x * 2;
  const int g = ch / (channels / num_groups);
  const size_t bq = (size_t)b * num_query + q;
  const float* lq = loc + bq * num_points * 2;
  const float* wq = weights + (bq * num_groups + g) * lv.n * num_points;
  const T* vb = value + (size_t)b * rows * channels + ch;

  float2 acc = make_float2(0.f, 0.f);
  for (int l = 0; l < lv.n; ++l) {
    const int h = lv.h[l];
    const int w = lv.w[l];
    const float hf = (float)h;
    const float wf = (float)w;
    const T* vl = vb + (size_t)lv.start[l] * channels;
    for (int p = 0; p < num_points; ++p) {
      const float x = __ldg(lq + 2 * p) * wf - 0.5f;
      const float y = __ldg(lq + 2 * p + 1) * hf - 0.5f;
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float dx = x - x0;
      const float dy = y - y0;
      // Validity in float, as in _corner_data: no int conversion of a
      // coordinate that may be far outside the map (or NaN).
      const bool vx0 = x0 >= 0.f && x0 < wf;
      const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f < wf;
      const bool vy0 = y0 >= 0.f && y0 < hf;
      const bool vy1 = y0 + 1.f >= 0.f && y0 + 1.f < hf;
      const float w00 = (vy0 && vx0) ? (1.f - dy) * (1.f - dx) : 0.f;
      const float w01 = (vy0 && vx1) ? (1.f - dy) * dx : 0.f;
      const float w10 = (vy1 && vx0) ? dy * (1.f - dx) : 0.f;
      const float w11 = (vy1 && vx1) ? dy * dx : 0.f;
      if (w00 == 0.f && w01 == 0.f && w10 == 0.f && w11 == 0.f) continue;
      const float a = __ldg(wq + l * num_points + p);
      const int ix = (int)x0;
      const int iy = (int)y0;
      if (w00 != 0.f) add_corner(acc, vl, iy * w + ix, channels, a * w00);
      if (w01 != 0.f) add_corner(acc, vl, iy * w + ix + 1, channels, a * w01);
      if (w10 != 0.f) add_corner(acc, vl, (iy + 1) * w + ix, channels, a * w10);
      if (w11 != 0.f) add_corner(acc, vl, (iy + 1) * w + ix + 1, channels, a * w11);
    }
  }
  Pair<T>::store(out + bq * channels + ch, acc);
}

// C entry point. Pointers are device pointers from torch's data_ptr();
// level_hw is a host array of num_levels (H, W) int pairs; stream is a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 = success).
// The caller has checked shapes, types, contiguity and alignment.
extern "C" int msda_fwd(const void* value, const void* loc, const void* weights,
                        void* out, int value_is_bf16, int batch, int num_query,
                        int num_points, int num_groups, int channels,
                        int num_levels, const void* level_hw, int rows,
                        void* stream) {
  if (num_levels < 1 || num_levels > MSDA_MAX_LEVELS || channels % 2 != 0 ||
      channels / 2 > 1024 || (channels / num_groups) % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  const int* hw = static_cast<const int*>(level_hw);
  int start = 0;
  for (int l = 0; l < num_levels; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  lv.n = num_levels;
  if (start != rows) return (int)cudaErrorInvalidValue;
  if (batch == 0 || num_query == 0) return 0;

  const int tx = channels / 2;
  const int ty = tx >= 256 ? 1 : 256 / tx;  // about 256 threads a block
  dim3 block(tx, ty);
  dim3 grid((num_query + ty - 1) / ty, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16) {
    msda_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(weights), static_cast<__nv_bfloat16*>(out), lv,
        num_query, num_points, num_groups, channels, rows);
  } else {
    msda_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(weights), static_cast<float*>(out), lv,
        num_query, num_points, num_groups, channels, rows);
  }
  return (int)cudaGetLastError();
}
