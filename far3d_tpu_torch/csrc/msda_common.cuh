// Pieces shared by the MSDA kernels (msda_fwd.cu, msda_bwd.cu): the level
// table, the bilinear corners of `_corner_data` (far3d_tpu_torch/ops/
// msda.py), and loads and stores of one lane's VEC consecutive channels as
// words of up to 16 bytes.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MSDA_MAX_LEVELS 8

namespace msda {

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];  // first row of the level in the value array
  int n;
};

// Fills `lv` from a host array of num_levels (H, W) int pairs; false when
// the level count is out of range or the levels do not cover `rows`.
inline bool make_levels(int num_levels, const void* level_hw, int rows,
                        Levels* lv) {
  if (num_levels < 1 || num_levels > MSDA_MAX_LEVELS) return false;
  const int* hw = static_cast<const int*>(level_hw);
  int start = 0;
  for (int l = 0; l < num_levels; ++l) {
    lv->h[l] = hw[2 * l];
    lv->w[l] = hw[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  lv->n = num_levels;
  return start == rows;
}

// The four bilinear corners of one (level, point): x = u*W - 0.5,
// y = v*H - 0.5, validity tested in float (no int conversion of a coordinate
// far outside the map, or NaN), each out-of-bounds corner on its own.
// Corner order (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1). u*W is rounded
// before the subtraction, as the plain version computes it: a fused
// multiply-add would move x by up to an ulp, 1.5e-5 on a map 240 wide, and
// the bilinear weights with it.
struct Corners {
  float w[4];      // bilinear weights, zero where the corner is out of bounds
  bool valid[4];   // corner in bounds
  int row[4];      // level-local row index of each valid corner
  float dx, dy;
};

__device__ __forceinline__ Corners corners(float u, float v, int h, int w) {
  const float hf = (float)h;
  const float wf = (float)w;
  const float x = __fmul_rn(u, wf) - 0.5f;
  const float y = __fmul_rn(v, hf) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Corners c;
  c.dx = x - x0;
  c.dy = y - y0;
  const bool vx0 = x0 >= 0.f && x0 < wf;
  const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f < wf;
  const bool vy0 = y0 >= 0.f && y0 < hf;
  const bool vy1 = y0 + 1.f >= 0.f && y0 + 1.f < hf;
  c.valid[0] = vy0 && vx0;
  c.valid[1] = vy0 && vx1;
  c.valid[2] = vy1 && vx0;
  c.valid[3] = vy1 && vx1;
  c.w[0] = c.valid[0] ? (1.f - c.dy) * (1.f - c.dx) : 0.f;
  c.w[1] = c.valid[1] ? (1.f - c.dy) * c.dx : 0.f;
  c.w[2] = c.valid[2] ? c.dy * (1.f - c.dx) : 0.f;
  c.w[3] = c.valid[3] ? c.dy * c.dx : 0.f;
  const int ix = (vx0 || vx1) ? (int)x0 : 0;
  const int iy = (vy0 || vy1) ? (int)y0 : 0;
  c.row[0] = iy * w + ix;
  c.row[1] = iy * w + ix + 1;
  c.row[2] = (iy + 1) * w + ix;
  c.row[3] = (iy + 1) * w + ix + 1;
  return c;
}

// The (H, W, first row) of level l, picked by an unrolled compare so that
// the kernel parameter `lv` is read at constant offsets: indexing it with a
// runtime level would copy it to local memory.
struct Level {
  int h, w, start;
};

__device__ __forceinline__ Level level(const Levels& lv, int l) {
  Level out{lv.h[0], lv.w[0], lv.start[0]};
#pragma unroll
  for (int k = 1; k < MSDA_MAX_LEVELS; ++k) {
    if (k == l) out = Level{lv.h[k], lv.w[k], lv.start[k]};
  }
  return out;
}

// One lane's VEC consecutive channels (VEC in 2, 4, 8, 16) as 32-bit words:
// N = VEC * sizeof(T) / 4 of them, moved as 16-byte words where N fills
// them, else one 8- or 4-byte word. The address is aligned to
// min(16, 4 * N) bytes.
template <typename T, int VEC>
__host__ __device__ constexpr int words() {
  return VEC * (int)sizeof(T) / 4;
}

template <int N>
__device__ __forceinline__ void load_words(const void* p, unsigned (&u)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k / 4);
      u[k] = v.x; u[k + 1] = v.y; u[k + 2] = v.z; u[k + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    u[0] = v.x; u[1] = v.y;
  } else {
    u[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

template <int N>
__device__ __forceinline__ void store_words(void* p, const unsigned (&u)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      reinterpret_cast<uint4*>(p)[k / 4] =
          make_uint4(u[k], u[k + 1], u[k + 2], u[k + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
  } else {
    *reinterpret_cast<unsigned*>(p) = u[0];
  }
}

__device__ __forceinline__ float2 unpack_bf16x2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// acc += a * (the VEC channels held in u), one fmaf a channel in order.
template <typename T, int VEC>
__device__ __forceinline__ void fma_words(float (&acc)[VEC], float a,
                                          const unsigned (&u)[words<T, VEC>()]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      const float2 f = unpack_bf16x2(u[k]);
      acc[2 * k] = fmaf(a, f.x, acc[2 * k]);
      acc[2 * k + 1] = fmaf(a, f.y, acc[2 * k + 1]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = fmaf(a, __uint_as_float(u[k]), acc[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[VEC]) {
  unsigned u[words<T, VEC>()];
  load_words(p, u);
#pragma unroll
  for (int k = 0; k < VEC; ++k) o[k] = 0.f;
  fma_words<T, VEC>(o, 1.f, u);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&a)[VEC]) {
  unsigned u[words<T, VEC>()];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) u[k] = pack_bf16x2(a[2 * k], a[2 * k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) u[k] = __float_as_uint(a[k]);
  }
  store_words(p, u);
}

}  // namespace msda
