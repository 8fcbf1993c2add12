// The tail of the EVA-02 ViT's SwiGLU (models/vit.py:SwiGLU) in one pass, for
// Hopper (sm_90a): the SiLU gate, the sub-LayerNorm ffn_ln and the zero
// padding of w3's input.
//
// Replaces no Pallas kernel: the JAX package has no ViT. The port first ran
// this tail as five PyTorch passes between the w12 and w3 matmuls: SiLU and
// the gate product on strided halves of the w12 output, LayerNorm's row
// moments and its scalar forward (the hidden width, 2,730, is not a multiple
// of 8), and the pad of its output to w3's 2,736-wide input.
//
// What it computes, for the w12 product ag (rows, 2 W), whose first half is
// the SiLU input a and second the gate g, each of hid real channels padded
// to W (a multiple of 8), and ffn_ln's weight and bias (hid) in ag's dtype:
//   s = silu(a) = a / (1 + exp(-a))    (rounded to the dtype)
//   p = s * g                          (rounded to the dtype)
//   out = (p - mean) * rsqrt(var + eps) * weight + bias   (rounded)
// with mean and the biased variance of p over the hid channels in float32,
// and out's channels hid..W-1 zero: w3's padded input. The two roundings are
// those of the PyTorch sequence, so s and p are bitwise its own; the
// normalized output may differ from PyTorch's LayerNorm by the order of
// the float32 sums.
//
// What bounds it: bytes. Each row reads a and g once and writes its output
// once: at 30,000 tokens and hid 2,730 in bf16, 491.8 MB a block, 0.147 ms at
// 3.35 TB/s.
//
// The design: one block a row, the whole row in registers (at most
// MAX_VECS 16-byte vectors of each half a thread, neighbouring threads on
// neighbouring vectors), so the row is read once: one load pass, two block
// reductions (the mean, then the squared deviations from it, each in a fixed
// order: no atomics, bitwise repeatable), one store pass. Rows, both halves
// and the output are 16-byte aligned (W a multiple of 8, the rows
// contiguous); only the last vector of a half is ragged. Three
// vectors a thread (128 threads at W = 2,736) ran faster on the H100 than
// two, four or five, or a persistent block prefetching its next row. The
// exact SiLU (expf and an IEEE division, as PyTorch computes it) takes about
// a quarter of the time: without it the pass ran at 87% of its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_VECS = 3;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The sum of v over the block, the same bits in every thread: a butterfly
// in each warp, then one over the warps' sums. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();  // red is written again by the next call
  return t;
}

template <typename T>
__global__ void swiglu_tail_kernel(const T* __restrict__ ag,
                                   const T* __restrict__ weight,
                                   const T* __restrict__ bias,
                                   T* __restrict__ out, int hid, int width,
                                   float eps) {
  constexpr int N = 16 / sizeof(T);  // elements of a 16-byte vector
  __shared__ float red[32];
  const int nvec = width / N;
  const T* a = ag + static_cast<long long>(blockIdx.x) * 2 * width;
  const T* g = a + width;
  float p[MAX_VECS][N];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_VECS; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
#pragma unroll
    for (int j = 0; j < N; ++j) p[k][j] = 0.f;
    if (v < nvec) {
      const uint4 ra = __ldg(reinterpret_cast<const uint4*>(a) + v);
      const uint4 rg = __ldg(reinterpret_cast<const uint4*>(g) + v);
      const T* ea = reinterpret_cast<const T*>(&ra);
      const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (v * N + j < hid) {
          const float x = to_f(ea[j]);
          const float s = to_f(from_f<T>(x / (1.f + expf(-x))));
          p[k][j] = to_f(from_f<T>(__fmul_rn(s, to_f(eg[j]))));
          sum += p[k][j];
        }
      }
    }
  }
  const float mean = block_sum(sum, red) / hid;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_VECS; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (v < nvec && v * N + j < hid) {
        const float d = p[k][j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / hid + eps);
  T* o = out + static_cast<long long>(blockIdx.x) * width;
#pragma unroll
  for (int k = 0; k < MAX_VECS; ++k) {
    const int v = threadIdx.x + k * blockDim.x;
    if (v >= nvec) continue;
    uint4 ro;
    T* eo = reinterpret_cast<T*>(&ro);
    if ((v + 1) * N <= hid) {
      const uint4 rw = __ldg(reinterpret_cast<const uint4*>(weight) + v);
      const uint4 rb = __ldg(reinterpret_cast<const uint4*>(bias) + v);
      const T* ew = reinterpret_cast<const T*>(&rw);
      const T* eb = reinterpret_cast<const T*>(&rb);
#pragma unroll
      for (int j = 0; j < N; ++j)
        eo[j] = from_f<T>((p[k][j] - mean) * rstd * to_f(ew[j]) + to_f(eb[j]));
    } else {  // the ragged last vector: weight and bias end at hid
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int c = v * N + j;
        eo[j] = c < hid ? from_f<T>((p[k][j] - mean) * rstd * to_f(weight[c])
                                    + to_f(bias[c]))
                        : from_f<T>(0.f);
      }
    }
    reinterpret_cast<uint4*>(o)[v] = ro;
  }
}

template <typename T>
int launch(const void* ag, const void* weight, const void* bias, void* out,
           int rows, int hid, int width, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int needed = (width / N + MAX_VECS - 1) / MAX_VECS;
  const int threads = (needed + 31) / 32 * 32;
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  swiglu_tail_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(ag), static_cast<const T*>(weight),
      static_cast<const T*>(bias), static_cast<T*>(out), hid, width, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ag (rows, 2 * width), weight and bias (hid), out (rows, width), all
// contiguous and of one dtype: bf16 (bf16 != 0) or float32. Requires width
// a multiple of 8 with hid <= width, the pointers 16-byte aligned, width at
// most 3 x 1024 16-byte vectors.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int swiglu_tail(const void* ag, const void* weight,
                           const void* bias, void* out, int rows, int hid,
                           int width, float eps, int bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16)
    return launch<__nv_bfloat16>(ag, weight, bias, out, rows, hid, width,
                                 eps, stream);
  return launch<float>(ag, weight, bias, out, rows, hid, width, eps, stream);
}
