// Multi-scale deformable sampling (MSDA), backward, for Hopper (sm_90a).
//
// Two kernels, one per TPU kernel of far3d_tpu/ops/msda_pallas.py:
//
//   msda_dval   replaces `msda_dval_kernel` (`_make_dval_kernel`, built by
//               `_build_dval_call`):
//                 d_value[b,row,ch] += w[b,q,g(ch),l,p] * bw_corner * g[b,q,ch]
//               summed over every (query, level, point, corner) whose corner
//               lands on `row`.
//   msda_dattn  replaces `msda_dattn_kernel` (`_make_dattn_kernel`, built by
//               `_build_dattn_call`) and the bilinear chain rule that
//               `_backward` then runs in XLA:
//                 d_weights[b,q,g,l,p] = sum_{ch in g} g[ch] * sample[ch]
//                 d_loc[b,q,p]        = sum_l sum_corner d_bw_corner * d bw / d loc
//               with sample = sum_corner bw * value[corner] and
//               d_bw_corner = sum_ch g[ch] * w[g(ch)] * value[corner, ch].
//
// The bilinear corners are those of `_corner_data` (far3d_tpu_torch/ops/
// msda.py) and of msda_fwd.cu: x = u*W - 0.5, y = v*H - 0.5, validity tested
// in float, each out-of-bounds corner on its own. A corner that is in bounds
// but has a zero bilinear weight (dx or dy exactly 0) still carries a
// location gradient, so msda_dattn tests validity, not the weight.
//
// What bounds them on an H100: bytes. Per hit corner msda_dval does two f32
// multiply-adds a channel and msda_dattn four, against 2 (bf16) or 4 (f32)
// bytes of value or gradient moved: far below the ~20 FLOP/byte where the f32
// CUDA cores would limit. msda_dval must write the whole d_value (45.7 MB in
// bf16 at the production training shape: 7 cameras x 12,750 rows x 256
// channels) and read the gradient rows of the queries that hit, the weights
// of the points that hit and all of loc. msda_dattn must read the value rows
// that some valid corner touches, the same gradient rows and weights, and
// write all of d_weights (f32) and d_loc. chip_smoke.py counts these bytes
// from the operands of a full-width train step.
//
// Design. msda_dval keeps the forward's thread layout: one row of C/2 threads
// per (camera, query), two channels a thread, corners computed by every
// thread of the row from a broadcast load, so a point that misses the map is
// a uniform branch with no traffic. Each hit corner is a scatter-add into an
// f32 scratch copy of d_value with atomicAdd (no bf16 atomics); a second pass
// casts the scratch to the value's dtype once (for f32 values the scratch is
// the output). Atomics make the summation order, and so the last bits of
// d_value, vary from run to run; chip_smoke.py reports by how much. The
// TPU kernel's one-hot S^T @ d_acc matmuls, query sort, chunk tables and
// VMEM splits exist because Mosaic cannot scatter; none is carried over.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MSDA_MAX_LEVELS 8

namespace {

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
};

template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// The bilinear corners of one (level, point), as in msda_fwd.cu.
struct Corners {
  float w[4];      // bilinear weights, zero where the corner is out of bounds
  bool valid[4];   // corner in bounds
  int row[4];      // level-local row index of each valid corner
  float dx, dy;
};

__device__ __forceinline__ Corners corners(float u, float v, int h, int w) {
  const float hf = (float)h;
  const float wf = (float)w;
  const float x = u * wf - 0.5f;
  const float y = v * hf - 0.5f;
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
  // int conversion only of coordinates known to be in bounds
  const int ix = (vx0 || vx1) ? (int)x0 : 0;
  const int iy = (vy0 || vy1) ? (int)y0 : 0;
  c.row[0] = iy * w + ix;
  c.row[1] = iy * w + ix + 1;
  c.row[2] = (iy + 1) * w + ix;
  c.row[3] = (iy + 1) * w + ix + 1;
  return c;
}

// ---------------------------------------------------------------- msda_dval

__device__ __forceinline__ void scatter_pair(float* level_grad, int row,
                                             int channels, float wgt,
                                             float2 g) {
  float* p = level_grad + (size_t)row * channels;
  atomicAdd(p, wgt * g.x);
  atomicAdd(p + 1, wgt * g.y);
}

// grad_out (B, Q, C) in T; loc (B, Q, P, 2) f32; weights (B, Q, G, L, P) f32;
// d_value32 (B, rows, C) f32, zeroed. Grid (ceil(Q / blockDim.y), B);
// block (C/2, queries per block).
template <typename T>
__global__ void msda_dval_kernel(const T* __restrict__ grad_out,
                                 const float* __restrict__ loc,
                                 const float* __restrict__ weights,
                                 float* __restrict__ d_value32, Levels lv,
                                 int num_query, int num_points,
                                 int num_groups, int channels, int rows) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.y + threadIdx.y;
  if (q >= num_query) return;
  const int ch = threadIdx.x * 2;
  const int g = ch / (channels / num_groups);
  const size_t bq = (size_t)b * num_query + q;
  const float2 go = Pair<T>::load(grad_out + bq * channels + ch);
  const float* lq = loc + bq * num_points * 2;
  const float* wq = weights + (bq * num_groups + g) * lv.n * num_points;
  float* db = d_value32 + (size_t)b * rows * channels + ch;

  for (int l = 0; l < lv.n; ++l) {
    float* dl = db + (size_t)lv.start[l] * channels;
    for (int p = 0; p < num_points; ++p) {
      const Corners c = corners(__ldg(lq + 2 * p), __ldg(lq + 2 * p + 1),
                                lv.h[l], lv.w[l]);
      if (c.w[0] == 0.f && c.w[1] == 0.f && c.w[2] == 0.f && c.w[3] == 0.f)
        continue;
      const float a = __ldg(wq + l * num_points + p);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c.w[k] != 0.f) scatter_pair(dl, c.row[k], channels, a * c.w[k], go);
      }
    }
  }
}

// f32 scratch -> bf16 d_value, two elements a thread and step.
__global__ void cast_to_bf16_kernel(const float* __restrict__ src,
                                    __nv_bfloat16* __restrict__ dst,
                                    size_t pairs) {
  const float2* s = reinterpret_cast<const float2*>(src);
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    d[i] = __float22bfloat162_rn(s[i]);
  }
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

bool make_levels(int num_levels, const void* level_hw, int rows, Levels* lv) {
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
// types, contiguity and alignment.

// d_value (B, rows, C) in the value's type; scratch (B, rows, C) f32, or the
// same pointer as d_value when the value is f32.
extern "C" int msda_dval(const void* grad_out, const void* loc,
                         const void* weights, void* d_value, void* scratch,
                         int value_is_bf16, int batch, int num_query,
                         int num_points, int num_groups, int channels,
                         int num_levels, const void* level_hw, int rows,
                         void* stream) {
  Levels lv;
  if (!make_levels(num_levels, level_hw, rows, &lv) || channels % 2 != 0 ||
      channels / 2 > 1024 || (channels / num_groups) % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)batch * rows * channels;
  cudaError_t err = cudaMemsetAsync(scratch, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  if (num_query > 0) {
    const int tx = channels / 2;
    const int ty = tx >= 256 ? 1 : 256 / tx;  // about 256 threads a block
    dim3 block(tx, ty);
    dim3 grid((num_query + ty - 1) / ty, batch);
    float* acc = static_cast<float*>(scratch);
    if (value_is_bf16) {
      msda_dval_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(grad_out),
          static_cast<const float*>(loc), static_cast<const float*>(weights),
          acc, lv, num_query, num_points, num_groups, channels, rows);
    } else {
      msda_dval_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(grad_out), static_cast<const float*>(loc),
          static_cast<const float*>(weights), acc, lv, num_query, num_points,
          num_groups, channels, rows);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (value_is_bf16) {
    const size_t pairs = n / 2;
    const int threads = 256;
    const size_t want = (pairs + threads - 1) / threads;
    const int blocks = (int)(want < 65535 * 8 ? want : 65535 * 8);
    cast_to_bf16_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(scratch),
        static_cast<__nv_bfloat16*>(d_value), pairs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
