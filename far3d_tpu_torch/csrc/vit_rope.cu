// The 2D rotary position embedding of the EVA-02 ViT's attention
// (models/vit.py:rope) on q and k in one pass, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no ViT. The port first ran
// the rotation as three PyTorch passes over strided views of the qkv
// product: x * cos, the pair swap's flip, and addcmul.
//
// What it computes, for x (G, B, H, S, D) (q and k: G = 2) whose last dim
// has stride 1 and whose other strides are given, and the tables cos and
// sin (S, D), contiguous and of x's dtype (sin carries the sign of the
// pair's rotation, models/vit.py:rope_tables), for each interleaved pair
// (a, b) = x[..., 2j : 2j + 2]:
//   out[..., 2j]     = a * cos[s, 2j]     + b * sin[s, 2j]
//   out[..., 2j + 1] = b * cos[s, 2j + 1] + a * sin[s, 2j + 1]
// in float32, rounded once to the dtype (the PyTorch passes round x * cos
// before the add), written dense with its dims in the order (B, S, G, H, D):
// the layout the PyTorch passes wrote for the qkv view, which the
// attention then reads.
//
// What bounds it: bytes. q and k are read once and written once: in a
// windowed block of the ViT cell (6 cameras of 64 x 112 padded tokens,
// 2,048 channels of q and k a token, bf16) 352.3 MB, 0.105 ms at 3.35 TB/s.
// The tables (at most 5,000 x 64 x 2 x 2 B in the cell) stay in L1 and L2.
//
// The design: a thread moves one 16-byte vector (8 bf16 values: four whole
// pairs), so the pair swap happens in registers. A token's G x H x D
// channels (4 KB of q and k in the cell, contiguous in the qkv product too)
// are one row of vectors, and a block is (a part of) one token's row:
// neighbouring threads on neighbouring vectors, so reads and writes are
// whole lines. At 32 registers (22 in float32) an SM holds 2,048 threads,
// whose loads keep the bytes in flight: on the H100, threads that each
// walked 2, 4 or 8 tokens ran at 78%, 61% and 39% of the bound at the
// cell's windowed block, one vector a thread at 88%. No shared memory and
// no reduction: bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

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

// dv: vectors of a head row (D / N); the strides of x's dims G, B, H, S in
// elements. blockIdx.x is the thread's token (b * seq + s), blockIdx.y *
// blockDim.x + threadIdx.x its vector of the token's row.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
vit_rope_kernel(const T* __restrict__ x, const T* __restrict__ cos_t,
                const T* __restrict__ sin_t, T* __restrict__ out, int dv,
                int heads, int groups, int seq, long long sg, long long sb,
                long long sh, long long ss) {
  constexpr int N = 16 / sizeof(T);  // elements of a 16-byte vector
  const int width = groups * heads * dv;  // vectors of a token's row
  const int w = blockIdx.y * blockDim.x + threadIdx.x;
  if (w >= width) return;
  // w walks the row (G, H, dv) in order, as the output does
  const int c = w % dv;
  const int h = w / dv % heads;
  const int g = w / (dv * heads);
  const int t = blockIdx.x;
  const int b = t / seq, s = t - b * seq;
  const T* xt = x + g * sg + b * sb + h * sh + s * ss + c * N;
  const int row = (s * dv + c) * N;
  const uint4 rx = __ldg(reinterpret_cast<const uint4*>(xt));
  const uint4 rc = __ldg(reinterpret_cast<const uint4*>(cos_t + row));
  const uint4 rs = __ldg(reinterpret_cast<const uint4*>(sin_t + row));
  const T* ex = reinterpret_cast<const T*>(&rx);
  const T* ec = reinterpret_cast<const T*>(&rc);
  const T* es = reinterpret_cast<const T*>(&rs);
  uint4 ro;
  T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    const float x0 = to_f(ex[j]), x1 = to_f(ex[j + 1]);
    eo[j] = from_f<T>(
        __fmaf_rn(x0, to_f(ec[j]), __fmul_rn(x1, to_f(es[j]))));
    eo[j + 1] = from_f<T>(
        __fmaf_rn(x1, to_f(ec[j + 1]), __fmul_rn(x0, to_f(es[j + 1]))));
  }
  reinterpret_cast<uint4*>(out)[static_cast<long long>(t) * width + w] = ro;
}

template <typename T>
int launch(const void* x, const void* cos_t, const void* sin_t, void* out,
           int tokens, int dv, int heads, int groups, int seq, long long sg,
           long long sb, long long sh, long long ss, cudaStream_t stream) {
  const int width = groups * heads * dv;
  const int threads = width < MAX_THREADS ? (width + 31) / 32 * 32
                                          : MAX_THREADS;
  const dim3 grid(tokens, (width + threads - 1) / threads);
  vit_rope_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(cos_t),
      static_cast<const T*>(sin_t), static_cast<T*>(out), dv, heads, groups,
      seq, sg, sb, sh, ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (groups, batch, heads, seq, dv * N) with the given strides (elements)
// of its first four dims and a last-dim stride of 1; cos and sin
// (seq, dv * N) contiguous; out dense in the order (batch, seq, groups,
// heads, dv * N); all of one dtype: bf16 (bf16 != 0, N = 8) or float32
// (N = 4). Requires the pointers and the strides 16-byte aligned, tokens =
// batch * seq > 0, and tokens * groups * heads * dv vectors below 2^30.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int vit_rope(const void* x, const void* cos_t, const void* sin_t,
                        void* out, int tokens, int dv, int heads, int groups,
                        int seq, long long sg, long long sb, long long sh,
                        long long ss, int bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16)
    return launch<__nv_bfloat16>(x, cos_t, sin_t, out, tokens, dv, heads,
                                 groups, seq, sg, sb, sh, ss, stream);
  return launch<float>(x, cos_t, sin_t, out, tokens, dv, heads, groups, seq,
                       sg, sb, sh, ss, stream);
}
