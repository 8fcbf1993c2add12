// Fused VoVNet OSA block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `make_osa_kernel` -> `kernel`
// (tools/dev_micro_osa_pallas.py:47-110, pallas_call at :118): per camera,
// five chained 3x3 convs with folded-BN scale and bias, ReLU and the
// pad-column mask, each rounded once to bf16; the 1x1 conv over the concat of
// the input and the five intermediates, walked source by source so that no
// concat is materialised; its scale, bias, ReLU and mask; and tsum, the
// per-channel sum of the f32 result over the plane (for the eSE gate).
//
// Layout (ops/osa.py): a plane is (rows = h*wp + 2*halo, channels), channels
// last, with zero halo rows above and below and zero pad columns wp - w >= 1
// at the end of every image row. A 3x3 tap (dy, dx) is the same rows shifted
// by dy*wp + dx, so no tap needs a test against the image's borders.
//
// What bounds it: operations. At stage 4 (7 cameras, 40x60, 768 -> 192 ->
// 768) the block is 134 GFLOP of bf16 products over about 69 MB of inputs
// and outputs, so the tensor cores set the least time, not the memory.
//
// What the design does about it. The TPU kernel keeps a camera's whole plane
// in VMEM; a Hopper block has 227 KB, so here every stage is an implicit
// GEMM over tiles of 192 rows x 192 output channels, one thread block a
// tile. The K loop walks "segments": for a 3x3 conv the nine taps of one
// source (A = the tile's rows shifted by the tap, B = that tap's c_in rows of
// the weight matrix), for the concat stage the six sources against the six
// row blocks of wcat. One producer warp asks the Tensor Memory Accelerator
// for each 64-deep slice (A: 192 rows x 64 channels, a 3D box whose row
// coordinate carries the tap's shift and whose out-of-range rows and channels
// arrive as zeros; B: 64 weight rows x 192 channels as three boxes) into a
// ring of four shared-memory stages in the 128-byte swizzle, and signals an
// mbarrier per stage. Three consumer warpgroups, 64 rows each, run
// wgmma.m64n192k16 (bf16 in, f32 accumulate in 96 registers a thread) from
// those stages, keep one group of products in flight, and hand a stage back
// through a second mbarrier. The epilogue applies scale, bias, ReLU and the
// mask in f32 on the accumulator registers and stores bf16. The
// intermediates c1..c5 go through device memory (38 MB at stage 4, which the
// 50 MB L2 mostly holds); the stages are separate launches on one stream
// because a 3x3 conv needs its neighbours' rows from the whole previous
// stage. tsum is summed per tile in a fixed order (registers, shuffles,
// shared memory) into per-tile partials, and a small second pass adds the
// tiles in order: no atomics, bitwise repeatable.
// Not done yet: one A slab shared by the nine taps, weights shared across a
// cluster, a persistent schedule that evens out the last wave of tiles.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int WGS = 3;                    // consumer warpgroups, 64 rows each
constexpr int BM = 64 * WGS;              // output rows of a block's tile
constexpr int BN = 192;                   // output channels of a block's tile
constexpr int BK = 64;                    // K depth of a stage: 128 bytes of bf16
constexpr int STAGES = 4;                 // depth of the shared-memory ring
constexpr int CONSUMERS = 128 * WGS;
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BOX_BYTES = BK * 64 * 2;  // one box of 64 weight rows x 64 channels
constexpr int B_BYTES = (BN / 64) * B_BOX_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RED_BYTES = (CONSUMERS / 32) * BN * 4;   // tsum: one row a warp
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + RED_BYTES + 128;
constexpr int MAX_SEG = 9;
constexpr int MAX_SRC = 6;
constexpr int MAX_HALO_BUFS = 6;

struct Segment {
  int map;                     // which source (tensor map) the segment reads
  int klen;                    // its channels: the K extent of the segment
  int row_off;                 // row shift of the tap, dy*wp + dx; 0 for concat
  int w_row;                   // first row of the segment in the weight matrix
};

struct StageArgs {
  Segment seg[MAX_SEG];
  int nseg;
  const float* scale;          // (n_out)
  const float* bias;           // (n_out)
  const __nv_bfloat16* mask;   // (r)
  __nv_bfloat16* dst;          // (n, rp, n_out)
  float* partial;              // (n, tiles_m, n_out), concat stage only
  int n_out, r, rp, halo, tiles_m;
};

struct StageMaps {
  CUtensorMap a[MAX_SRC];      // (n, rp, channels) sources, box 1 x BM x 64
  CUtensorMap b;               // (rows, n_out) weights, box 64 x 64
};

struct HaloArgs {
  __nv_bfloat16* buf[MAX_HALO_BUFS];   // each (n, rp, ld[i])
  int ld[MAX_HALO_BUFS];
  int n, r, rp, halo;
};

// D (64 x 192, f32, 96 registers a thread) (+)= A (64 x 16, K-major in shared
// memory) x B (16 x 192, channel-major in shared memory: trans-b = 1).
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// One stage: dst[cam, halo + m, n] = mask[m] * relu(scale[n] * sum_seg
// sum_k src_seg[cam, halo + m + row_off_seg, k] * w[w_row_seg + k, n] + bias[n])
// for the tile m in [blockIdx.y*BM, +BM), n in [blockIdx.x*BN, +BN) of camera
// blockIdx.z. Rows m >= r and channels n >= n_out are not written; source
// rows outside the camera's plane and channels past a source's width read as
// zeros (the tensor maps' out-of-range fill).
template <bool TSUM>
__global__ void __launch_bounds__(THREADS, 1)
osa_stage_kernel(const __grid_constant__ StageMaps maps, const StageArgs p) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes, and every tile starts on one
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES
                                               + RED_BYTES);
  const uint32_t tiles = smem_u32(smem);
  const uint32_t full = smem_u32(bars);              // [STAGES]: a stage landed
  const uint32_t empty = smem_u32(bars + STAGES);    // [STAGES]: a stage was read

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int cam = blockIdx.z;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                    // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS / 32);      // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  int total = 0;                           // ring stages over all segments
  for (int s = 0; s < p.nseg; ++s) total += (p.seg[s].klen + BK - 1) / BK;

  if (warp == CONSUMERS / 32) {
    // ---- producer warp: one lane feeds the ring through the TMA ----------
    if (lane == 0) {
      const int boxes = min(BN / 64, (p.n_out - n0 + 63) / 64);
      int seg_i = 0, kk = 0;
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const Segment sg = p.seg[seg_i];
        const uint32_t bar = full + 8 * s;
        const uint32_t a_dst = tiles + s * STAGE_BYTES;
        mbar_expect_tx(bar, A_BYTES + boxes * B_BOX_BYTES);
        tma_load_3d(a_dst, &maps.a[sg.map], bar, kk,
                    p.halo + m0 + sg.row_off, cam);
        for (int j = 0; j < boxes; ++j)
          tma_load_2d(a_dst + A_BYTES + j * B_BOX_BYTES, &maps.b, bar,
                      n0 + j * 64, sg.w_row + kk);
        kk += BK;
        if (kk >= sg.klen) {
          kk = 0;
          ++seg_i;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows wg*64 .. +64 of the tile -----------------
  const int wg = warp >> 2;
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int s = it % STAGES;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    const uint32_t a_tile = tiles + s * STAGE_BYTES + wg * (64 * BK * 2);
    const uint32_t b_tile = tiles + s * STAGE_BYTES + A_BYTES;
    // A: rows of 128 bytes, eight rows a swizzle pattern (1024 bytes apart);
    // 16 channels further is 32 bytes further. B: weight rows of 128 bytes
    // (64 channels), eight rows a pattern, the next 64 channels one box
    // further; 16 weight rows further is 2048 bytes further.
    const uint64_t desc_a = wgmma_desc(a_tile, 16, 1024);
    const uint64_t desc_b = wgmma_desc(b_tile, B_BOX_BYTES, 1024);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_m64n192k16(acc, desc_a + ks * (32 >> 4), desc_b + ks * (2048 >> 4),
                       (it | ks) != 0);
    wgmma_commit();
    if (it > 0) {
      wgmma_wait<1>();                     // the products of stage it-1 are done
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
  }
  wgmma_wait<0>();

  // Epilogue on the accumulator layout of wgmma.m64nN: a warp holds 16 rows,
  // a thread rows g and g + 8 and channels 8j + 2t, 8j + 2t + 1 for j < N/8.
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + warp * 16 + g;
  __nv_bfloat16* drow[2];
  float mk[2];
  bool row_ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + half * 8;
    row_ok[half] = row < p.r;
    mk[half] = row_ok[half] ? __bfloat162float(p.mask[row]) : 0.f;
    drow[half] = p.dst
        + (static_cast<long long>(cam) * p.rp + p.halo + row) * p.n_out;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + t * 2;
    const bool col_ok = col < p.n_out;     // n_out is even, so col + 1 too
    const float s0 = col_ok ? p.scale[col] : 0.f;
    const float s1 = col_ok ? p.scale[col + 1] : 0.f;
    const float b0 = col_ok ? p.bias[col] : 0.f;
    const float b1 = col_ok ? p.bias[col + 1] : 0.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // multiply, then add, each rounded, as the plain version does
      float v0 = __fadd_rn(__fmul_rn(acc[j * 4 + half * 2], s0), b0);
      float v1 = __fadd_rn(__fmul_rn(acc[j * 4 + half * 2 + 1], s1), b1);
      v0 = fmaxf(v0, 0.f) * mk[half];
      v1 = fmaxf(v1, 0.f) * mk[half];
      if (row_ok[half] && col_ok)
        *reinterpret_cast<__nv_bfloat162*>(drow[half] + col) =
            __floats2bfloat162_rn(v0, v1);
      sum0 += col_ok ? v0 : 0.f;
      sum1 += col_ok ? v1 : 0.f;
    }
    if (TSUM) {                            // this warp's 16 rows, in a fixed order
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 4);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 4);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 8);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 8);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 16);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 16);
      if (g == 0) {
        red[warp * BN + j * 8 + t * 2] = sum0;
        red[warp * BN + j * 8 + t * 2 + 1] = sum1;
      }
    }
  }
  if (TSUM) {
    asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
    if (tid < BN && n0 + tid < p.n_out) {
      float sum = 0.f;                     // the tile's warps, in order
#pragma unroll
      for (int w = 0; w < CONSUMERS / 32; ++w) sum += red[w * BN + tid];
      p.partial[(static_cast<long long>(cam) * p.tiles_m + blockIdx.y)
                    * p.n_out + n0 + tid] = sum;
    }
  }
}

// tsum[cam, n] = the tiles' partial sums, added in tile order.
__global__ void osa_tsum_kernel(const float* __restrict__ partial,
                                float* __restrict__ tsum, int tiles_m,
                                int n_out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int cam = blockIdx.y;
  if (col >= n_out) return;
  float s = 0.f;
  for (int tile = 0; tile < tiles_m; ++tile)
    s += partial[(static_cast<long long>(cam) * tiles_m + tile) * n_out + col];
  tsum[cam * n_out + col] = s;
}

// Zero the halo rows [0, halo) and [halo + r, rp) of every camera of every
// buffer (blockIdx.y), 16 bytes a thread: the buffers come uninitialised.
__global__ void osa_zero_halo_kernel(const HaloArgs p) {
  const int ld = p.ld[blockIdx.y];
  __nv_bfloat16* buf = p.buf[blockIdx.y];
  const int chunks = ld / 8;
  const int halo_rows = p.rp - p.r;
  const long long total = static_cast<long long>(p.n) * halo_rows * chunks;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(i % chunks);
    const int hr = static_cast<int>((i / chunks) % halo_rows);
    const long long cam = i / (static_cast<long long>(chunks) * halo_rows);
    const int row = hr < p.halo ? hr : p.r + hr;
    reinterpret_cast<uint4*>(buf + (cam * p.rp + row) * ld)[ch] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// A bf16 tensor of `rank` dimensions (innermost first) with a box of the
// same rank, 128-byte swizzle, zeros for what lies outside.
bool encode_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[2];
  cuuint64_t stride = sizeof(__nv_bfloat16);
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool source_map(CUtensorMap* map, const void* base, int n, int rp, int ld) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld),
                              static_cast<cuuint64_t>(rp),
                              static_cast<cuuint64_t>(n)};
  const cuuint32_t box[3] = {BK, BM, 1};
  return encode_map(map, base, 3, dims, box);
}

bool weight_map(CUtensorMap* map, const void* base, int rows, int n_out) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n_out),
                              static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[2] = {64, BK};
  return encode_map(map, base, 2, dims, box);
}

template <bool TSUM>
cudaError_t launch_stage(const StageMaps& maps, const StageArgs& a, int n,
                         cudaStream_t stream) {
  auto kernel = osa_stage_kernel<TSUM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_out + BN - 1) / BN, a.tiles_m, n);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

// x (n, rp, cin), w1 (9*cin, cm), w2345 (4*9*cm, cm), wcat (cin + 5*cm, cout)
// and mask (r) bf16; s5, b5 (5, cm) and sc, bc (cout) f32; scratch
// (5, n, rp, cm) bf16, y (n, rp, cout) bf16, partial (n, ceil(r/192), cout)
// and tsum (n, cout) f32 are written. r = h*wp, rp = r + 2*halo. Requires
// halo >= wp, cin % 8 == cm % 8 == cout % 8 == 0 and 16-byte aligned
// pointers (checked by the caller). Returns the first CUDA error of its
// launches, cudaErrorUnknown if a tensor map cannot be made, 0 if none.
extern "C" int osa_fused(const void* x, const void* mask, const void* w1,
                         const void* w2345, const void* wcat, const void* s5,
                         const void* b5, const void* sc, const void* bc,
                         void* scratch, void* y, void* partial, void* tsum,
                         int n, int h, int wp, int halo, int cin, int cm,
                         int cout, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int r = h * wp, rp = r + 2 * halo;
  const int tiles_m = (r + BM - 1) / BM;
  __nv_bfloat16* c[5];
  for (int i = 0; i < 5; ++i)
    c[i] = static_cast<__nv_bfloat16*>(scratch)
           + static_cast<long long>(i) * n * rp * cm;
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);

  HaloArgs hz;
  for (int i = 0; i < 5; ++i) {
    hz.buf[i] = c[i];
    hz.ld[i] = cm;
  }
  hz.buf[5] = yb;
  hz.ld[5] = cout;
  hz.n = n;
  hz.r = r;
  hz.rp = rp;
  hz.halo = halo;
  osa_zero_halo_kernel<<<dim3(64, MAX_HALO_BUFS), 256, 0, stream>>>(hz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // sources 0..5: x, c1..c5
  StageMaps cat_maps;
  bool ok = source_map(&cat_maps.a[0], x, n, rp, cin);
  for (int i = 0; i < 5; ++i)
    ok = ok && source_map(&cat_maps.a[i + 1], c[i], n, rp, cm);
  ok = ok && weight_map(&cat_maps.b, wcat, cin + 5 * cm, cout);
  StageMaps conv_maps;
  CUtensorMap w1_map, w2345_map;
  ok = ok && weight_map(&w1_map, w1, 9 * cin, cm)
       && weight_map(&w2345_map, w2345, 4 * 9 * cm, cm);
  if (!ok) return static_cast<int>(cudaErrorUnknown);

  StageArgs a;
  a.mask = static_cast<const __nv_bfloat16*>(mask);
  a.r = r;
  a.rp = rp;
  a.halo = halo;
  a.tiles_m = tiles_m;
  a.partial = nullptr;
  for (int i = 0; i < 5; ++i) {            // the five 3x3 convs
    const int c_in = i == 0 ? cin : cm;
    conv_maps.a[0] = cat_maps.a[i];        // x, then c1..c4
    conv_maps.b = i == 0 ? w1_map : w2345_map;
    a.nseg = 9;
    for (int k = 0; k < 9; ++k) {
      a.seg[k].map = 0;
      a.seg[k].klen = c_in;
      a.seg[k].row_off = (k / 3 - 1) * wp + (k % 3 - 1);
      a.seg[k].w_row = (i == 0 ? 0 : (i - 1) * 9 * cm) + k * c_in;
    }
    a.scale = static_cast<const float*>(s5) + i * cm;
    a.bias = static_cast<const float*>(b5) + i * cm;
    a.dst = c[i];
    a.n_out = cm;
    err = launch_stage<false>(conv_maps, a, n, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  a.nseg = 6;                              // the 1x1 conv over the six sources
  for (int i = 0; i < 6; ++i) {
    a.seg[i].map = i;
    a.seg[i].klen = i == 0 ? cin : cm;
    a.seg[i].row_off = 0;
    a.seg[i].w_row = i == 0 ? 0 : cin + (i - 1) * cm;
  }
  a.scale = static_cast<const float*>(sc);
  a.bias = static_cast<const float*>(bc);
  a.dst = yb;
  a.n_out = cout;
  a.partial = static_cast<float*>(partial);
  err = launch_stage<true>(cat_maps, a, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  osa_tsum_kernel<<<dim3((cout + 127) / 128, n), 128, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(tsum), tiles_m,
      cout);
  return static_cast<int>(cudaGetLastError());
}
