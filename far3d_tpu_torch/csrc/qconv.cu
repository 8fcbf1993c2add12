// int8 convolution with a fused requantising epilogue, for Hopper (sm_90a).
//
// Replaces the XLA s8 convolution of the JAX package's int8 serving backbone,
// `_qconv` (far3d_tpu/ops/quant.py:228-240): there is no Pallas kernel for
// it, XLA runs `lax.conv_general_dilated(..., preferred_element_type=int32)`
// and fuses the float epilogue behind it. PyTorch has no int8 convolution on
// the card, so this is the port's own.
//
// What it computes, for NHWC s8 activations x (n, h, w, ci), weights
// (co, k, k, ci) s8, per-channel f32 multipliers a and b, stride s and
// SAME padding p = (k - 1) / 2 on every side:
//   acc[m, o] = sum over (ky, kx, c) of x[img, oy*s - p + ky, ox*s - p + kx, c]
//               * w[o, ky, kx, c]                       (exact, s32)
//   y = relu(float(acc) * a[o] + b[o])   (a rounded product, then a rounded
//                                         sum: __fmul_rn, __fadd_rn, no FMA)
//   out = y (f32)                        for the concat conv of an OSA block
//   out = clip(rint(y), 0, 127) (s8)     elsewhere (rint: half to even)
// with m = (img, oy, ox) the output pixel. Out-of-image taps read zeros.
//
// What bounds it: operations, except for the stem's first conv (ci = 3,
// K = 27), which moves more bytes than it multiplies. A full-width frame is
// 2.83 T int8 operations (a multiply-add counts 2) over 7 images; at the
// card's 1,979 dense int8 TOPS that is 1.43 ms.
//
// The design, a first version that is right and simple: an implicit GEMM
// over M = n*ho*wo output pixels, N = co and K = k*k*ci, K ordered
// (ky, kx, c) so that a pixel's channels are contiguous. A block of 128
// threads computes a 128 x 64 tile of the output; 4 warps of 64 x 32, each
// 4 x 4 mma.sync.m16n8k32 s8 x s8 -> s32 tiles, their fragments read with
// ldmatrix. The K loop walks 64-byte slices through a ring of three
// shared-memory stages filled with cp.async (16 bytes a copy when ci is a
// multiple of 16, 4 when of 4; single bytes, loaded synchronously,
// otherwise), out-of-range taps, rows, channels and K zero-filled by the
// copy itself. Shared rows are 80 bytes apart so that the fragment reads hit
// 32 distinct banks. The pixel decode of the tile's 128 rows is done once per
// block into shared memory; with 16-byte copies each thread keeps its rows'
// pointers in registers and steps its K column from stage to stage. The
// epilogue runs in registers and writes straight to device memory, a pair of
// neighbouring channels per store.
// Not done yet: wgmma with TMA, an output staged through shared memory for
// wide stores, reading an OSA block's concat inputs in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;             // output pixels of a block's tile
constexpr int BN = 64;              // output channels of a block's tile
constexpr int BK = 64;              // K bytes of a stage
constexpr int LDS = BK + 16;        // shared row pitch: conflict-free fragments
constexpr int STAGES = 3;
constexpr int THREADS = 128;        // 4 warps, 2 (M) x 2 (N), 64 x 32 each

struct Row {
  int base;   // img * h * w
  int iy0;    // oy * s - p; far below 0 for a row past M
  int ix0;    // ox * s - p
};

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* a;
  const float* b;
  void* out;
  int m, h, w_in, ci, co, k, stride, pad, ho, wo, kdim;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of VEC bytes (4 or 16) that fills zeros where `valid` is false.
template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? VEC : 0;
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The A side of a stage (BM pixels x BK bytes of K). With 16-byte copies a
// thread copies one 16-byte column of K for 4 rows, the same column every
// stage: its rows' image pointers and corners stay in registers, and the
// tap and channel of its column advance by BK a stage (stages are loaded in
// order). Narrower copies take each row's corner from the block's decoded
// rows in shared memory and decode their K index every stage.
template <int VEC>
struct ALoader {
  static constexpr int CPR = BK / VEC;         // copies a row
  static constexpr int RPT = BM / (THREADS / CPR);   // rows a thread
  const int8_t* base[VEC == 16 ? RPT : 1];
  int iy0[VEC == 16 ? RPT : 1], ix0[VEC == 16 ? RPT : 1];
  int col, tap, c, ky, kx;

  __device__ __forceinline__ void init(const Args& p, const Row* rows) {
    col = (threadIdx.x % CPR) * VEC;
    if constexpr (VEC == 16) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const Row row = rows[threadIdx.x / CPR + i * (THREADS / CPR)];
        base[i] = p.x + static_cast<long long>(row.base) * p.ci;
        iy0[i] = row.iy0;
        ix0[i] = row.ix0;
      }
      tap = col / p.ci;
      c = col - tap * p.ci;
      ky = tap / p.k;
      kx = tap - ky * p.k;
    }
  }

  __device__ __forceinline__ void load(const Args& p, const Row* rows,
                                       int8_t* As, int k0) {
    if constexpr (VEC == 16) {
      const bool k_ok = tap < p.k * p.k;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int iy = iy0[i] + ky, ix = ix0[i] + kx;
        const bool ok = k_ok && static_cast<unsigned>(iy) < p.h &&
                        static_cast<unsigned>(ix) < p.w_in;
        const int8_t* src = ok ? base[i] + (iy * p.w_in + ix) * p.ci + c
                               : p.x;
        copy_async<16>(As + (threadIdx.x / CPR + i * (THREADS / CPR)) * LDS
                           + col, src, ok);
      }
      c += BK;                                 // the next stage's column
      while (c >= p.ci) {
        c -= p.ci;
        if (++kx == p.k) {
          kx = 0;
          ++ky;
        }
        ++tap;
      }
    } else {
      const int kk = k0 + col;
      const bool k_ok = kk < p.kdim;
      const int t = k_ok ? kk / p.ci : 0;
      const int cc = kk - t * p.ci;
      const int yy = t / p.k, xx = t - (t / p.k) * p.k;
#pragma unroll 4
      for (int r = threadIdx.x / CPR; r < BM; r += THREADS / CPR) {
        const Row row = rows[r];
        const int iy = row.iy0 + yy, ix = row.ix0 + xx;
        const bool ok = k_ok && iy >= 0 && iy < p.h && ix >= 0 &&
                        ix < p.w_in;
        const int8_t* src =
            ok ? p.x + (static_cast<long long>(row.base) + iy * p.w_in + ix)
                           * p.ci + cc
               : p.x;
        int8_t* dst = As + r * LDS + col;
        if constexpr (VEC == 1) {
          *dst = ok ? *src : int8_t(0);
        } else {
          copy_async<VEC>(dst, src, ok);
        }
      }
    }
  }
};

// The B side of a stage (BN output channels x BK bytes of K): a thread's
// weight rows and K column are the same every stage.
template <int VEC>
__device__ __forceinline__ void load_b(const Args& p, int8_t* Bs, int k0,
                                       int n0) {
  constexpr int CPR = BK / VEC;
  const int col = (threadIdx.x % CPR) * VEC;
  const int kk = k0 + col;
  const bool k_ok = kk < p.kdim;
#pragma unroll 4
  for (int r = threadIdx.x / CPR; r < BN; r += THREADS / CPR) {
    const int o = n0 + r;
    const bool ok = k_ok && o < p.co;
    const int8_t* src = ok ? p.w + static_cast<long long>(o) * p.kdim + kk
                           : p.w;
    int8_t* dst = Bs + r * LDS + col;
    if constexpr (VEC == 1) {
      *dst = ok ? *src : int8_t(0);
    } else {
      copy_async<VEC>(dst, src, ok);
    }
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 tiles of 16-bit lanes from shared memory: an m16n8k32 s8
// fragment is such a tile read as bytes.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// relu(float(acc) * a + b), rounded once after the product and once after
// the sum, then as stored: f32, or rint and clip to [0, 127] as s8.
template <bool FLOAT_OUT>
__device__ __forceinline__ float epilogue(int acc, float a, float b) {
  const float y = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), a), b), 0.f);
  return FLOAT_OUT ? y : fminf(rintf(y), 127.0f);
}

template <int VEC, bool FLOAT_OUT>
__global__ void __launch_bounds__(THREADS)
    qconv_kernel(const Args p) {
  __shared__ __align__(16) int8_t As[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * LDS];
  __shared__ Row rows[BM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  {
    const int m = m0 + tid;            // THREADS == BM: one row a thread
    Row row{0, -(1 << 28), 0};
    if (m < p.m) {
      const int hw = p.ho * p.wo;
      const int img = m / hw, rem = m - img * hw;
      const int oy = rem / p.wo, ox = rem - oy * p.wo;
      row.base = img * p.h * p.w_in;
      row.iy0 = oy * p.stride - p.pad;
      row.ix0 = ox * p.stride - p.pad;
    }
    rows[tid] = row;
  }
  __syncthreads();
  ALoader<VEC> a_load;
  a_load.init(p, rows);

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 64, wn = (warp % 2) * 32;
  const int g = lane / 4, t = lane % 4;
  // this lane's row and byte offsets into the ldmatrix tiles
  const int a_off = (wm + (lane % 8) + ((lane / 8) % 2) * 8) * LDS
                    + (lane / 16) * 16;
  const int b_off = (wn + (lane % 8) + (lane / 16) * 8) * LDS
                    + ((lane / 8) % 2) * 16;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (p.kdim + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      a_load.load(p, rows, As[s], s * BK);
      load_b<VEC>(p, Bs[s], s * BK, n0);
    }
    commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    wait_groups<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) {
      a_load.load(p, rows, As[next % STAGES], next * BK);
      load_b<VEC>(p, Bs[next % STAGES], next * BK, n0);
    }
    commit();
    const int8_t* A = As[kt % STAGES];
    const int8_t* B = Bs[kt % STAGES];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(af[i], A + a_off + i * 16 * LDS + ks);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, B + b_off + j * 8 * LDS + ks);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  wait_groups<0>();

  // epilogue: c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at row g + 8; a
  // pair is stored as one 8-byte (f32) or 2-byte (s8) word where co is even
  float* out_f = static_cast<float*>(p.out);
  int8_t* out_q = static_cast<int8_t*>(p.out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = n0 + wn + j * 8 + t * 2;
    if (o >= p.co) continue;
    const bool second = o + 1 < p.co;
    const bool pair = second && (p.co % 2) == 0;
    const float a0 = p.a[o], b0 = p.b[o];
    const float a1 = second ? p.a[o + 1] : 0.f;
    const float b1 = second ? p.b[o + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + i * 16 + g + half * 8;
        if (m >= p.m) continue;
        const long long at = static_cast<long long>(m) * p.co + o;
        const float y0 = epilogue<FLOAT_OUT>(acc[i][j][half * 2], a0, b0);
        const float y1 = epilogue<FLOAT_OUT>(acc[i][j][half * 2 + 1], a1, b1);
        if constexpr (FLOAT_OUT) {
          if (pair) {
            *reinterpret_cast<float2*>(out_f + at) = make_float2(y0, y1);
          } else {
            out_f[at] = y0;
            if (second) out_f[at + 1] = y1;
          }
        } else {
          const signed char q0 = static_cast<signed char>(y0);
          const signed char q1 = static_cast<signed char>(y1);
          if (pair) {
            *reinterpret_cast<char2*>(out_q + at) = make_char2(q0, q1);
          } else {
            out_q[at] = q0;
            if (second) out_q[at + 1] = q1;
          }
        }
      }
    }
  }
}

template <int VEC>
cudaError_t launch(const Args& p, bool float_out, cudaStream_t stream) {
  const dim3 grid((p.m + BM - 1) / BM, (p.co + BN - 1) / BN);
  if (float_out)
    qconv_kernel<VEC, true><<<grid, THREADS, 0, stream>>>(p);
  else
    qconv_kernel<VEC, false><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (n, h, w, ci) s8, w (co, k, k, ci) s8, a and b (co,) f32, all contiguous
// on one device; out (n, ho, wo, co), f32 if float_out else s8. Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int qconv(const void* x, const void* w, const void* a,
                     const void* b, void* out, int n, int h, int w_in, int ci,
                     int co, int k, int stride, int ho, int wo, int float_out,
                     void* stream_ptr) {
  Args p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.out = out;
  p.m = n * ho * wo;
  p.h = h;
  p.w_in = w_in;
  p.ci = ci;
  p.co = co;
  p.k = k;
  p.stride = stride;
  p.pad = (k - 1) / 2;
  p.ho = ho;
  p.wo = wo;
  p.kdim = k * k * ci;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ci % 16 == 0) return static_cast<int>(launch<16>(p, float_out, stream));
  if (ci % 4 == 0) return static_cast<int>(launch<4>(p, float_out, stream));
  return static_cast<int>(launch<1>(p, float_out, stream));
}
