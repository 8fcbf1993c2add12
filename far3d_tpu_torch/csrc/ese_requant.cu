// The tail of an int8 OSA block in one pass, for Hopper (sm_90a): the eSE
// gate, the identity add and the requantization.
//
// Replaces the float epilogue that the JAX package's int8 backbone leaves to
// XLA after the concat conv (far3d_tpu/ops/quant.py:252-256, no Pallas
// kernel), which the port first ran as some ten PyTorch passes over the f32
// concat output.
//
// What it computes, for the concat conv's f32 output y (n, h, w, C), the
// eSE gate (n, C) = hsig(mean_hw(y) @ ese_w + ese_b) that the wrapper
// computes from the conv's channel sums, the block input x_id (n, h, w, C)
// int8 (a channel slice, pixels xid_pitch bytes apart) and the scalars s_id
// and r_out:
//   v = y * gate                               (rounded)
//   v = v + float(x_id) * s_id                 (each rounded; identity blocks)
//   out = clip(rint(v * r_out), 0, 127) int8   (rounded, then half to even)
// in the plain version's order, with no fused multiply-add, into a channel
// slice (pixels out_pitch bytes apart: slice 0 of the next block's concat
// buffer, or a plain tensor).
//
// What bounds it: bytes. Each element is read once as f32 (and once as s8
// for an identity block) and written once as s8; a full-width frame's 16
// blocks move about 1.7 GB, 0.5 ms at 3.35 TB/s.
//
// The design: a grid-stride loop of threads that each take four channels of
// a pixel: one 16-byte load of y, one 4-byte load of x_id, the four gates
// (an L1-resident (n, C) table), one 4-byte store. Neighbouring threads take
// neighbouring channels, so a warp's loads and stores are whole lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ signed char requant(float v, float r) {
  return static_cast<signed char>(
      fminf(fmaxf(rintf(__fmul_rn(v, r)), 0.f), 127.f));
}

template <bool IDENTITY>
__global__ void ese_requant_kernel(const float* __restrict__ y,
                                   const float* __restrict__ gate,
                                   const int8_t* __restrict__ xid,
                                   const float* __restrict__ s_id,
                                   const float* __restrict__ r_out,
                                   int8_t* __restrict__ out, int quads,
                                   int c4, int hw, int xid_pitch,
                                   int out_pitch) {
  const float r = *r_out;
  const float sid = IDENTITY ? *s_id : 0.f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += gridDim.x * blockDim.x) {
    const int pix = i / c4;
    const int c = (i - pix * c4) * 4;
    const float4 v = reinterpret_cast<const float4*>(y)[i];
    const float4 gt = *reinterpret_cast<const float4*>(
        gate + (pix / hw) * (c4 * 4) + c);
    float v0 = __fmul_rn(v.x, gt.x), v1 = __fmul_rn(v.y, gt.y);
    float v2 = __fmul_rn(v.z, gt.z), v3 = __fmul_rn(v.w, gt.w);
    if (IDENTITY) {
      const char4 x = *reinterpret_cast<const char4*>(
          xid + static_cast<long long>(pix) * xid_pitch + c);
      v0 = __fadd_rn(v0, __fmul_rn(static_cast<float>(x.x), sid));
      v1 = __fadd_rn(v1, __fmul_rn(static_cast<float>(x.y), sid));
      v2 = __fadd_rn(v2, __fmul_rn(static_cast<float>(x.z), sid));
      v3 = __fadd_rn(v3, __fmul_rn(static_cast<float>(x.w), sid));
    }
    *reinterpret_cast<char4*>(out + static_cast<long long>(pix) * out_pitch
                              + c) =
        make_char4(requant(v0, r), requant(v1, r), requant(v2, r),
                   requant(v3, r));
  }
}

}  // namespace

// y (n, h, w, c) f32 contiguous, gate (n, c) f32, x_id (pixels xid_pitch
// bytes apart) int8 or null, s_id and r_out f32 scalars on the device, out
// (pixels out_pitch bytes apart) int8. Requires c, the pitches and the
// pointers of x_id and out multiples of 4. Returns the CUDA error of the
// launch (0 when it was accepted).
extern "C" int ese_requant(const void* y, const void* gate, const void* x_id,
                           int xid_pitch, const void* s_id, const void* r_out,
                           void* out, int out_pitch, int n, int h, int w,
                           int c, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int quads = n * h * w * (c / 4);
  const int threads = 256;
  const int blocks = min((quads + threads - 1) / threads, 132 * 16);
  const float* yf = static_cast<const float*>(y);
  const float* gf = static_cast<const float*>(gate);
  const int8_t* xq = static_cast<const int8_t*>(x_id);
  const float* sf = static_cast<const float*>(s_id);
  const float* rf = static_cast<const float*>(r_out);
  int8_t* oq = static_cast<int8_t*>(out);
  if (x_id != nullptr)
    ese_requant_kernel<true><<<blocks, threads, 0, stream>>>(
        yf, gf, xq, sf, rf, oq, quads, c / 4, h * w, xid_pitch, out_pitch);
  else
    ese_requant_kernel<false><<<blocks, threads, 0, stream>>>(
        yf, gf, xq, sf, rf, oq, quads, c / 4, h * w, xid_pitch, out_pitch);
  return static_cast<int>(cudaGetLastError());
}
