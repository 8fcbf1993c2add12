// int8 convolution with a fused requantising epilogue, for Hopper (sm_90a).
//
// Replaces the XLA s8 convolution of the JAX package's int8 serving backbone,
// `_qconv` (far3d_tpu/ops/quant.py:228-240): there is no Pallas kernel for
// it, XLA runs `lax.conv_general_dilated(..., preferred_element_type=int32)`
// and fuses the float epilogue behind it. PyTorch has no int8 convolution on
// the card, so this is the port's own.
//
// What it computes, for NHWC s8 activations x (n, h, w, ci) whose pixels lie
// x_pitch bytes apart (a channel slice of a wider buffer), weights
// (co, k, k, ci) s8, per-channel f32 multipliers a and b, stride s and SAME
// padding p = (k - 1) / 2 on every side:
//   acc[m, o] = sum over (ky, kx, c) of x[img, oy*s - p + ky, ox*s - p + kx, c]
//               * w[o, ky, kx, c]                       (exact, s32)
//   y = relu(float(acc) * a[o] + b[o])   (a rounded product, then a rounded
//                                         sum: __fmul_rn, __fadd_rn, no FMA)
//   out = y (f32)                        for the concat conv of an OSA block
//   out = clip(rint(y), 0, 127) (s8)     elsewhere (rint: half to even)
// with m = (img, oy, ox) the output pixel, written out_pitch elements apart
// (into a channel slice of a wider buffer). Out-of-image taps read zeros. An
// f32 output may also give its per-channel sums over each image, added in a
// fixed order (the eSE gate's mean).
//
// What bounds it: operations, except for the stem's first conv (ci = 3,
// K = 27), which moves more bytes than it multiplies. A full-width frame is
// 2.83 T int8 operations (a multiply-add counts 2) over 7 images; at the
// card's 1,979 dense int8 TOPS that is 1.43 ms.
//
// Two routes, chosen by the wrapper from the shapes alone.
//
// TMA + wgmma (16-byte aligned rows, co a multiple of 16: 98 of a frame's
// 99 convs). An implicit GEMM whose M tile is a bh x bw box of output
// pixels of one image (128 pixels, or 192 for the int8 outputs of at
// most 192 channels; the box shape chosen to waste the least at the image's
// width) and whose N tile is the whole co of a layer conv (64-224, each a
// legal s8 wgmma width; half of 224 at stage 5, whose 35 tiles would leave
// most SMs idle) or 128 / 256 channels of a concat conv. K is walked in
// units of one tap and 128, 64 or 32 channels (ci = 128a + 64b + 32c, so
// no K is wasted at any of the model's widths: 160 and 224 would pad to 192
// and 256 in 64-channel units): the Tensor Memory Accelerator loads a unit
// of A as a 4-D box (width, bw, bh, 1) of the input at the tile's pixels
// shifted by the tap, and fills zeros for coordinates outside the image and
// channels past ci, which gives the SAME padding and a ragged ci for free,
// with no halo; a unit of B is a (width, 1, BN) box of the weights seen as
// (ci, k*k, co); at stride 2 the A box spans twice the tile's pixels and
// loads every other one (the map's element strides). Units land in shared
// memory in the swizzle of their width, K-major as 8-bit wgmma requires.
// A ring stage is 128 bytes of K a row (one
// unit of 128, two of 64 or four of 32; the integer sum is exact, so K runs
// all the 128-channel units first), so every stage is four
// wgmma.m64nNk32.s32.s8.s8 with constant trip counts, which keeps ptxas from
// serialising them. Wide boxes matter: a 32-byte unit asks the TMA for one
// 32-byte row a pixel, four times the requests of a 128-byte one for the
// same bytes. One producer warp keeps a
// ring of up to eight stages full behind mbarriers; two or three consumer
// warpgroups (64 rows each) hold the s32 sums in registers (N/2 a thread),
// one stage of products in flight. Blocks are persistent: one an SM, or two
// for the narrow tiles whose registers allow it (one block's epilogue then
// overlaps the other's products), walking the tiles N tile first so that
// the N tiles of a block of pixels share its activations in L2; the
// producer runs on into the next tile while the consumers store this one.
// The epilogue rounds as above. An int8 tile goes through shared memory,
// 16 rows a warp, and out as 16-byte stores into the output slice (channel
// pairs stored straight from the registers write 8 bytes of a row's 32-byte
// sector a quad). An f32 tile is stored from the registers, a quad
// writing whole 32-byte sectors, and sums each channel over its valid rows
// (registers, shuffles, then the warps in order) into a per-tile partial; a
// second small pass adds the tiles in order: no atomics, bitwise
// repeatable.
//
// mma.sync (rows not 16-byte aligned: the stem's first conv, whose pixels
// are 3 bytes, and the tiny config's 8-48-channel slices): the first
// version. 128 x 64 tiles over M = n*ho*wo, 4 warps of mma.sync.m16n8k32 s8 -> s32 fragments read
// with ldmatrix from a ring of three cp.async stages that zero-fill
// out-of-range taps, rows, channels and K (16-, 4- or 1-byte copies as the
// alignment allows); the epilogue stores from registers, channel pairs
// where aligned. Its f32 sums come from one pass over the output's rows.
// Not done yet: a path of its own for the stem's first conv (K = 27), an
// f32 epilogue that overlaps the next tile (a TMA store), the weights
// multicast across a cluster, a split of K for stage 4's 98 tiles.

#include "hopper.cuh"

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
  int x_pitch, out_pitch;   // bytes / elements between neighbouring pixels
  bool pair;                // channel pairs may be stored as one word
};

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
        base[i] = p.x + static_cast<long long>(row.base) * p.x_pitch;
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
        const int8_t* src = ok ? base[i] + (iy * p.w_in + ix) * p.x_pitch + c
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
                           * p.x_pitch + cc
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
    qconv_mma_kernel(const Args p) {
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
    const bool pair = second && p.pair;
    const float a0 = p.a[o], b0 = p.b[o];
    const float a1 = second ? p.a[o + 1] : 0.f;
    const float b1 = second ? p.b[o + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + i * 16 + g + half * 8;
        if (m >= p.m) continue;
        const long long at = static_cast<long long>(m) * p.out_pitch + o;
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
    qconv_mma_kernel<VEC, true><<<grid, THREADS, 0, stream>>>(p);
  else
    qconv_mma_kernel<VEC, false><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// dst[img, c] = sum over r < rows of src[img, r, c] (row pitch `pitch`),
// added in row order: the per-channel sums of an f32 output, from its rows
// (mma.sync route) or from its tiles' partial sums (TMA route).
__global__ void qconv_column_sums_kernel(const float* __restrict__ src,
                                         float* __restrict__ dst, int rows,
                                         int cols, int pitch) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int img = blockIdx.y;
  if (c >= cols) return;
  const float* s = src + static_cast<long long>(img) * rows * pitch + c;
  float sum = 0.f;
  for (int r = 0; r < rows; ++r) sum += s[static_cast<long long>(r) * pitch];
  dst[img * cols + c] = sum;
}

cudaError_t column_sums(const float* src, float* dst, int n, int rows,
                        int cols, int pitch, cudaStream_t stream) {
  qconv_column_sums_kernel<<<dim3((cols + 127) / 128, n), 128, 0, stream>>>(
      src, dst, rows, cols, pitch);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The TMA + wgmma route: 16-byte aligned rows.
// ---------------------------------------------------------------------------
namespace tma {

// K is walked in units of one tap and 128, 64 or 32 channels (kinds 0, 1,
// 2): a unit is one TMA box of A and one of B, in the swizzle of its width.
// A ring stage is 128 bytes of K a row: one unit of 128, two of 64 or four
// of 32.
constexpr int KB = 128;          // K bytes of a ring stage
constexpr int KINDS = 3;
constexpr int MAX_STAGES = 8;
static_assert(kSwizzle128B == 1 && kSwizzle64B == 2 && kSwizzle32B == 3,
              "a kind's wgmma swizzle is kind + 1");

template <int N>
struct WgmmaS8;

// D (64 x N, s32, N/2 registers a thread) += A (64 x 32 s8, K-major) x
// B (N x 32 s8, K-major), both from shared memory.
template <>
struct WgmmaS8<64> {
  __device__ static __forceinline__ void mma(int (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaS8<112> {
  __device__ static __forceinline__ void mma(int (&d)[56], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, %56, %57, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ static __forceinline__ void mma(int (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaS8<160> {
  __device__ static __forceinline__ void mma(int (&d)[80], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaS8<192> {
  __device__ static __forceinline__ void mma(int (&d)[96], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaS8<224> {
  __device__ static __forceinline__ void mma(int (&d)[112], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111"
        "}, %112, %113, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaS8<256> {
  __device__ static __forceinline__ void mma(int (&d)[128], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

struct Args {
  const float* a;
  const float* b;
  void* out;
  float* partial;       // (n, tiles, co) per-tile channel sums, or null
  int ho, wo, co, out_pitch, k, pad, stride;   // output extent
  int per_tap[KINDS];   // units of each kind a tap: ci = 128 a + 64 b + 32 c
  int first_c[KINDS];   // the first channel of a tap's units of each kind
  int stage0[KINDS + 1];  // the kinds' first ring stages, then the total
  int bw, bh, tiles_x;  // a tile is bh rows of bw pixels of one image
  int tiles;            // tiles an image
  int n_tiles;          // N tiles: ceil(co / BN)
  int total;            // tiles of the launch: n_tiles * tiles * n
};

struct Maps {
  CUtensorMap x[KINDS];   // (ci, w, h, n) u8, box width x bw x bh x 1
  CUtensorMap w[KINDS];   // (ci, k*k, co) u8, box width x 1 x BN
};

constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may have
constexpr int SMEM_SM = 233472;      // an SM's, of which 1 KB a block is reserved

template <int WGS, int BN, bool FLOAT_OUT>
struct Shape {
  static constexpr int BM = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;      // and one producer warp
  // Tiles whose registers allow it (narrow N) run two blocks an SM, so that
  // one block's epilogue overlaps the other's products.
  static constexpr int BLOCKS =
      WGS == 2 && (BN <= 112 || (FLOAT_OUT && BN == 128)) ? 2 : 1;
  static constexpr int STAGE = (BM + BN) * KB;
  // after the ring: an f32 tile's per-warp channel sums, or an int8 tile's
  // 16 rows a warp, each row padded by 16 bytes so that a quad's stores hit
  // other banks than its neighbours'
  static constexpr int STG_PITCH = BN + 16;
  static constexpr int EPI = FLOAT_OUT ? (CONSUMERS / 32) * BN * 4
                                       : (CONSUMERS / 32) * 16 * STG_PITCH;
  static constexpr int BUDGET =
      BLOCKS == 1 ? SMEM_LIMIT : SMEM_SM / BLOCKS - 1024;
  static constexpr int FIT = (BUDGET - 1024 - EPI - 2 * MAX_STAGES * 8)
                             / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = 1024 + STAGES * STAGE + EPI + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "a ring needs two stages");
};

// The kind of K unit of ring stage `it` of a tile.
__device__ __forceinline__ int stage_kind(const Args& p, int it) {
  return it < p.stage0[1] ? 0 : it < p.stage0[2] ? 1 : 2;
}

struct Tile {
  int n0, img, tile, oy0, ox0;
};

// Tile t of the launch: N tile fastest, so that the N tiles of a block of
// pixels run together and read its activations from L2 once.
__device__ __forceinline__ Tile tile_of(const Args& p, int t, int bn) {
  Tile r;
  const int rest = t / p.n_tiles;
  r.n0 = (t - rest * p.n_tiles) * bn;
  r.img = rest / p.tiles;
  r.tile = rest - r.img * p.tiles;
  const int ty = r.tile / p.tiles_x;
  r.oy0 = ty * p.bh;
  r.ox0 = (r.tile - ty * p.tiles_x) * p.bw;
  return r;
}

// A persistent block walks tiles t = blockIdx.x, + gridDim.x, ...: out[img,
// oy0 + y, ox0 + x, n0 + j] for y < bh, x < bw, j < BN. The s32 sum is
// exact, so the order of K is free: the units of 128 channels of every tap
// first, then those of 64, then those of 32, packed into the ring stages; a
// kind's last stage is filled up with units past the last tap, whose weight
// boxes read zeros, so that every stage is four k32 products. The producer
// runs on into the next tile's stages while the consumers store this one.
template <int WGS, int BN, bool FLOAT_OUT>
__global__ void __launch_bounds__(Shape<WGS, BN, FLOAT_OUT>::THREADS,
                                  Shape<WGS, BN, FLOAT_OUT>::BLOCKS)
qconv_tma_kernel(const __grid_constant__ Maps maps, const Args p) {
  using S = Shape<WGS, BN, FLOAT_OUT>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes, and every tile starts on one
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* epi = smem + S::STAGES * S::STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(epi + S::EPI);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(bars);              // [STAGES]: a stage landed
  const uint32_t empty = smem_u32(bars + S::STAGES);  // [STAGES]: a stage was read

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                     // the producer's expect_tx
      mbar_init(empty + 8 * s, S::CONSUMERS / 32);    // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int stages = p.stage0[KINDS];     // ring stages a tile

  if (warp == S::CONSUMERS / 32) {
    // ---- producer warp: one lane feeds the ring through the TMA ----------
    if (lane == 0) {
      const int taps = p.k * p.k;
      int g_it = 0;                        // ring stages over all tiles
      for (int t = blockIdx.x; t < p.total; t += gridDim.x) {
        const Tile tl = tile_of(p, t, BN);
        for (int it = 0; it < stages; ++it, ++g_it) {
          const int s = g_it % S::STAGES;
          mbar_wait(empty + 8 * s, ((g_it / S::STAGES) & 1) ^ 1);
          const int kind = stage_kind(p, it);
          const int width = KB >> kind;
          const int per_tap = kind == 0 ? p.per_tap[0]
                              : kind == 1 ? p.per_tap[1] : p.per_tap[2];
          const int first_c = kind == 0 ? 0 : kind == 1 ? p.first_c[1]
                                                        : p.first_c[2];
          const int stage0 = kind == 0 ? 0 : kind == 1 ? p.stage0[1]
                                                       : p.stage0[2];
          const uint32_t bar = full + 8 * s;
          mbar_expect_tx(bar, S::STAGE);
          for (int u = 0; u < (1 << kind); ++u) {
            const int unit = (it - stage0) * (1 << kind) + u;
            const int tap = min(unit / per_tap, taps);   // taps: zeros
            const int c0 = first_c + (unit % per_tap) * width;
            const int ky = tap / p.k, kx = tap - ky * p.k;
            const uint32_t dst = ring + s * S::STAGE
                                 + u * (S::BM + BN) * width;
            // the tile's pixels shifted by the tap; outside the image, and
            // past ci, the box reads zeros
            tma_load_4d(dst, &maps.x[kind], bar, c0,
                        tl.ox0 * p.stride + kx - p.pad,
                        tl.oy0 * p.stride + ky - p.pad, tl.img);
            tma_load_3d(dst + S::BM * width, &maps.w[kind], bar, c0, tap,
                        tl.n0);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: tile rows wg*64 .. +64 ------------------------
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  int g_it = 0;
  for (int t = blockIdx.x; t < p.total; t += gridDim.x) {
    const Tile tl = tile_of(p, t, BN);
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    for (int it = 0; it < stages; ++it, ++g_it) {
      const int s = g_it % S::STAGES;
      mbar_wait(full + 8 * s, (g_it / S::STAGES) & 1);
      const int kind = stage_kind(p, it);
      const int width = KB >> kind;
      const uint32_t stage = ring + s * S::STAGE;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < KB / 32; ++q) {
        // k32 step q lies in unit q*32 / width at byte q*32 % width; a unit
        // is rows of `width` bytes in the swizzle of that width, eight rows
        // a pattern
        const int u = (q * 32) >> (7 - kind);
        const uint32_t base = stage + u * (S::BM + BN) * width
                              + ((q * 32) & (width - 1));
        WgmmaS8<BN>::mma(
            acc, wgmma_desc(base + wg * 64 * width, 16, 8 * width, kind + 1),
            wgmma_desc(base + S::BM * width, 16, 8 * width, kind + 1));
      }
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();                   // the products of stage it-1 are done
        if (lane == 0) mbar_arrive(empty + 8 * ((g_it - 1) % S::STAGES));
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * ((g_it - 1) % S::STAGES));

    // Epilogue on the accumulator layout of wgmma.m64nN: a warp holds 16
    // rows, a thread rows g and g + 8 and channels 8j + 2t4, 8j + 2t4 + 1 for
    // j < N/8.
    const int row0 = wg * 64 + (warp & 3) * 16;
    if constexpr (FLOAT_OUT) {
      float* red = reinterpret_cast<float*>(epi);
      const bool tsum = p.partial != nullptr;
      long long at[2];
      bool row_ok[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = row0 + g + half * 8;
        const int ly = m / p.bw;
        const int oy = tl.oy0 + ly, ox = tl.ox0 + (m - ly * p.bw);
        row_ok[half] = oy < p.ho && ox < p.wo;
        at[half] = ((static_cast<long long>(tl.img) * p.ho + oy) * p.wo + ox)
                   * p.out_pitch;
      }
      float* out_f = static_cast<float*>(p.out);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int o = tl.n0 + j * 8 + t4 * 2;
        const bool col_ok = o < p.co;      // co is a multiple of 16: o + 1 too
        const float a0 = col_ok ? p.a[o] : 0.f, a1 = col_ok ? p.a[o + 1] : 0.f;
        const float b0 = col_ok ? p.b[o] : 0.f, b1 = col_ok ? p.b[o + 1] : 0.f;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float y0 = epilogue<true>(acc[j * 4 + half * 2], a0, b0);
          const float y1 = epilogue<true>(acc[j * 4 + half * 2 + 1], a1, b1);
          if (row_ok[half] && col_ok)      // a quad writes 32-byte sectors
            *reinterpret_cast<float2*>(out_f + at[half] + o) =
                make_float2(y0, y1);
          if (row_ok[half]) {
            sum0 += y0;
            sum1 += y1;
          }
        }
        if (tsum) {                        // this warp's 16 rows, in a fixed order
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, 4);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, 4);
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, 8);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, 8);
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, 16);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, 16);
          if (g == 0) {
            red[warp * BN + j * 8 + t4 * 2] = sum0;
            red[warp * BN + j * 8 + t4 * 2 + 1] = sum1;
          }
        }
      }
      if (tsum) {
        asm volatile("bar.sync 1, %0;\n" :: "n"(S::CONSUMERS) : "memory");
        for (int c = tid; c < BN && tl.n0 + c < p.co; c += S::CONSUMERS) {
          float sum = 0.f;                 // the tile's warps, in order
#pragma unroll
          for (int w = 0; w < S::CONSUMERS / 32; ++w) sum += red[w * BN + c];
          p.partial[(static_cast<long long>(tl.img) * p.tiles + tl.tile)
                    * p.co + tl.n0 + c] = sum;
        }
        // the next tile's sums go into the same shared memory
        asm volatile("bar.sync 1, %0;\n" :: "n"(S::CONSUMERS) : "memory");
      }
    } else {
      // int8: the warp's 16 rows through shared memory, then 16-byte stores
      unsigned char* stg = epi + warp * 16 * S::STG_PITCH;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int o = tl.n0 + j * 8 + t4 * 2;
        const bool col_ok = o < p.co;
        const float a0 = col_ok ? p.a[o] : 0.f, a1 = col_ok ? p.a[o + 1] : 0.f;
        const float b0 = col_ok ? p.b[o] : 0.f, b1 = col_ok ? p.b[o + 1] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<char2*>(stg + (g + half * 8) * S::STG_PITCH
                                    + j * 8 + t4 * 2) = make_char2(
              static_cast<signed char>(
                  epilogue<false>(acc[j * 4 + half * 2], a0, b0)),
              static_cast<signed char>(
                  epilogue<false>(acc[j * 4 + half * 2 + 1], a1, b1)));
      }
      __syncwarp();
      int8_t* out_q = static_cast<int8_t*>(p.out);
      constexpr int CHUNKS = BN / 16;      // 16-byte pieces of a row
      for (int c = lane; c < 16 * CHUNKS; c += 32) {
        const int r = c / CHUNKS, piece = c - r * CHUNKS;
        const int m = row0 + r;
        const int ly = m / p.bw;
        const int oy = tl.oy0 + ly, ox = tl.ox0 + (m - ly * p.bw);
        const int o = tl.n0 + piece * 16;
        if (oy < p.ho && ox < p.wo && o < p.co)
          *reinterpret_cast<uint4*>(
              out_q + ((static_cast<long long>(tl.img) * p.ho + oy) * p.wo + ox)
                      * p.out_pitch + o) =
              *reinterpret_cast<const uint4*>(stg + r * S::STG_PITCH
                                              + piece * 16);
      }
      __syncwarp();                        // the next tile's rows go there too
    }
  }
}

template <int WGS, int BN, bool FLOAT_OUT>
cudaError_t launch(const Maps& maps, const Args& p, cudaStream_t stream) {
  using S = Shape<WGS, BN, FLOAT_OUT>;
  auto kernel = qconv_tma_kernel<WGS, BN, FLOAT_OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        S::THREADS, S::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent blocks, as many as fit (S::BLOCKS an SM where they should)
  const int grid = min(p.total, sms * per_sm);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(maps, p);
  return cudaGetLastError();
}

// The instantiations the wrapper's plan picks from: int8 outputs take the
// layer convs' widths (and half of 224, for stage 5's grid of 35 tiles), and
// three warpgroups (192-pixel tiles) for the narrower ones; f32 outputs (the
// concat convs, co 256-1024) 128 or 256.
cudaError_t launch_plan(const Maps& maps, const Args& p, int wgs, int bn,
                        bool float_out, cudaStream_t stream) {
  if (wgs == 2 && float_out) {
    switch (bn) {
      case 128: return launch<2, 128, true>(maps, p, stream);
      case 256: return launch<2, 256, true>(maps, p, stream);
    }
  } else if (wgs == 2) {
    switch (bn) {
      case 64: return launch<2, 64, false>(maps, p, stream);
      case 112: return launch<2, 112, false>(maps, p, stream);
      case 128: return launch<2, 128, false>(maps, p, stream);
      case 160: return launch<2, 160, false>(maps, p, stream);
      case 192: return launch<2, 192, false>(maps, p, stream);
      case 224: return launch<2, 224, false>(maps, p, stream);
      case 256: return launch<2, 256, false>(maps, p, stream);
    }
  } else if (wgs == 3 && !float_out) {
    switch (bn) {
      case 128: return launch<3, 128, false>(maps, p, stream);
      case 160: return launch<3, 160, false>(maps, p, stream);
      case 192: return launch<3, 192, false>(maps, p, stream);
    }
  }
  return cudaErrorInvalidValue;
}

// A u8 tensor of `rank` dimensions (innermost first) with the given byte
// strides of dimensions 1.., a box of the same rank whose inner width
// (128, 64 or 32 bytes) is also its swizzle, traversed with the given
// element strides (a box loads ceil(box / stride) elements a dimension),
// zeros for what lies outside.
bool encode_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box, const cuuint32_t* elem_strides) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const CUtensorMapSwizzle swizzle =
      box[0] == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma

}  // namespace

// mma.sync route. x (n, h, w, ci) s8 with pixels x_pitch bytes apart, w
// (co, k, k, ci) s8 contiguous, a and b (co,) f32; out (n, ho, wo, co) with
// pixels out_pitch elements apart, f32 if float_out else s8; sums (n, co)
// f32, the per-channel sums of an f32 output, or null. Returns the CUDA
// error of the launches (0 when they were accepted).
extern "C" int qconv_mma(const void* x, int x_pitch, const void* w,
                         const void* a, const void* b, void* out,
                         int out_pitch, void* sums, int n, int h, int w_in,
                         int ci, int co, int k, int stride, int ho, int wo,
                         int float_out, void* stream_ptr) {
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
  p.x_pitch = x_pitch;
  p.out_pitch = out_pitch;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  p.pair = co % 2 == 0 && out_pitch % 2 == 0
           && oa % (float_out ? 8 : 2) == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (ci % 16 == 0 && x_pitch % 16 == 0 && xa % 16 == 0)
    err = launch<16>(p, float_out, stream);
  else if (ci % 4 == 0 && x_pitch % 4 == 0 && xa % 4 == 0)
    err = launch<4>(p, float_out, stream);
  else
    err = launch<1>(p, float_out, stream);
  if (err == cudaSuccess && float_out && sums != nullptr)
    err = column_sums(static_cast<const float*>(out),
                      static_cast<float*>(sums), n, ho * wo, co, out_pitch,
                      stream);
  return static_cast<int>(err);
}

// TMA + wgmma route, same operands; x's base, x_pitch, w's base,
// ci, out's base and out_pitch bytes multiples of 16, co of 16. The wrapper
// plans the tile: wgs consumer warpgroups (2, or 3 for an int8 output of at
// most 192 channels: tiles of 128 or 192 pixels, bw x bh of them), bn
// channels an N tile. partial (n, tiles, co) f32 takes the per-tile channel
// sums when sums is not null. Returns the first CUDA error of the launches,
// cudaErrorUnknown if a tensor map cannot be made, cudaErrorInvalidValue for
// a plan with no instantiation.
extern "C" int qconv_tma(const void* x, int x_pitch, const void* w,
                         const void* a, const void* b, void* out,
                         int out_pitch, void* partial, void* sums, int n,
                         int h, int w_in, int ci, int co, int k, int stride,
                         int float_out, int wgs, int bn, int bw, int bh,
                         void* stream_ptr) {
  using namespace tma;
  if (bw * bh != 64 * wgs || bw * stride > 256 || bh * stride > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  tma::Args p;
  // ci = 128 a + 64 b + 32 c with b, c in {0, 1}; the last unit may reach
  // past ci, where the boxes read zeros
  p.per_tap[0] = ci / KB;
  p.per_tap[1] = (ci % KB) / 64;
  p.per_tap[2] = (ci % 64 + 31) / 32;
  p.first_c[0] = 0;
  p.first_c[1] = p.per_tap[0] * KB;
  p.first_c[2] = p.first_c[1] + p.per_tap[1] * 64;
  p.stage0[0] = 0;
  Maps maps;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(ci),
                                static_cast<cuuint64_t>(w_in),
                                static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(n)};
  const cuuint64_t x_strides[3] = {
      static_cast<cuuint64_t>(x_pitch),
      static_cast<cuuint64_t>(x_pitch) * w_in,
      static_cast<cuuint64_t>(x_pitch) * w_in * h};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(ci),
                                static_cast<cuuint64_t>(k * k),
                                static_cast<cuuint64_t>(co)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(ci),
                                   static_cast<cuuint64_t>(ci) * k * k};
  for (int kind = 0; kind < KINDS; ++kind) {
    const int units = k * k * p.per_tap[kind];
    p.stage0[kind + 1] =
        p.stage0[kind] + (units + (1 << kind) - 1) / (1 << kind);
    if (units == 0) continue;
    const cuuint32_t width = KB >> kind;
    // a stride-2 conv's box spans twice its pixels and loads every other
    const cuuint32_t x_box[4] = {width, static_cast<cuuint32_t>(bw * stride),
                                 static_cast<cuuint32_t>(bh * stride), 1};
    const cuuint32_t x_steps[4] = {1, static_cast<cuuint32_t>(stride),
                                   static_cast<cuuint32_t>(stride), 1};
    const cuuint32_t w_box[3] = {width, 1, static_cast<cuuint32_t>(bn)};
    const cuuint32_t w_steps[3] = {1, 1, 1};
    if (!encode_map(&maps.x[kind], x, 4, x_dims, x_strides, x_box, x_steps)
        || !encode_map(&maps.w[kind], w, 3, w_dims, w_strides, w_box,
                       w_steps))
      return static_cast<int>(cudaErrorUnknown);
  }

  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.out = out;
  p.partial = sums != nullptr ? static_cast<float*>(partial) : nullptr;
  p.k = k;
  p.pad = (k - 1) / 2;
  p.stride = stride;
  p.ho = (h + 2 * p.pad - k) / stride + 1;
  p.wo = (w_in + 2 * p.pad - k) / stride + 1;
  p.co = co;
  p.out_pitch = out_pitch;
  p.bw = bw;
  p.bh = bh;
  p.tiles_x = (p.wo + bw - 1) / bw;
  p.tiles = p.tiles_x * ((p.ho + bh - 1) / bh);
  p.n_tiles = (co + bn - 1) / bn;
  p.total = p.n_tiles * p.tiles * n;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = launch_plan(maps, p, wgs, bn, float_out, stream);
  if (err == cudaSuccess && p.partial != nullptr)
    err = column_sums(p.partial, static_cast<float*>(sums), n, p.tiles, co,
                      co, stream);
  return static_cast<int>(err);
}
