// The 2x2x2 transposed conv (kernel == stride) on NDHWC fp32 and its
// backward, on the FP64 tensor cores at fp32 accuracy, for Hopper (sm_90a).
// Plain C interface, bound with ctypes (ops/upsample.py: upsample2x,
// upsample2x_dx and upsample2x_dw on fp32 tensors). The bf16 kernels of the
// same functions are upsample2x.cu and upsample2x_bwd.cu.
//
// Replaces, at compute dtype float32, the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_upsample.py::_fwd_kernel
//                                                   -> upsample2x_f32
//   ::_dx_kernel                                    -> upsample2x_dx_f32
//   ::_dw_kernel                                    -> upsample2x_dw_f32
// which the JAX package runs at any compute dtype (their tiles sized by the
// itemsize).
//   forward  y[2q + p, co] = sum_ci x[q, ci] wf[p, ci, co]
//   dx       dx[q, ci] = sum_{p, co} gy[2q + p, co] wf[p, ci, co]
//   dW       dwf[p, ci, co] = sum_q x[q, ci] gy[2q + p, co]
// for the 8 parities p = (a, b, c) = 4a + 2b + c and coarse voxels q.
//
// Products. mma.sync.m16n8k8.f64 on the FP64 tensor cores (wgmma has no
// fp64 form): an fp32 operand converts to fp64 exactly and the product of
// two is exact, the sums round to nearest in fp64 in a fixed order, so the
// output's only error is its final rounding to fp32 (f32_gemm.cuh says why
// not 3xTF32). No atomics: two runs are bit-equal.
//
// What bounds them on the H100 (per launch at N = 2, each the same for the
// forward and dx): 128 -> 64 from 32^3 does 8.6 GFLOP, 128 us at the FP64
// tensor cores' 67 TFLOP/s, against 168 MB, 50 us of HBM; 64 -> 32 from
// 64^3 does 17.2 GFLOP, 256 us, against 671 MB, 200 us (y, or gy, is four
// fifths of the bytes). So both are bound by the FP64 tensor cores, with
// bytes close behind at 64 -> 32. At that rate an SM takes one m16n8k8
// (1,024 FMAs) every ~8 cycles and reads 128 bytes of shared memory a
// cycle, so each fragment byte has to serve several MMAs from registers
// and each operand is converted to fp64 once, not at every fragment read.
//
// Design of the forward and dx (the fp32 brick kernels' warp split, on the
// bf16 upsample's dataflow):
//   Warps. A block is 8 MMA warps and 4 producer warps, one block an SM.
//     The output tile of a block is M coarse voxels (consecutive in the
//     flat (n, d, h, w) order) x NCOL columns, M x NCOL = 8192, each MMA
//     warp 32 x 32 of it (2 x 4 MMA tiles, 32 fp64 sums a thread).
//   Steps. A tile's K runs in steps of KC channels. The producers cp.async
//     a step's fp32 rows (16 bytes, zero-filled past the last voxel) into a
//     3-stage ring two steps ahead, and convert each staged element once
//     into one of two fp64 buffers, [KC / 8][row][8 channels], while the
//     MMA warps multiply the other; named barriers hand the buffers over
//     ("full": converted, "empty": multiplied). The ring flows across
//     tiles, so one tile's epilogue overlaps the next tile's copies and
//     conversion. Persistent blocks: block b of a column group walks tiles
//     [b * T / B, (b + 1) * T / B).
//   Fragments. A lane's two k of an m16n8k8 fragment (k = t and t + 4) are
//     channels 2t and 2t + 1, adjacent in a 64-byte row of 8 channels, so
//     every fragment is one 16-byte load and each quarter-warp reads 128
//     contiguous bytes. A buffer's planes of 8 channels are R * 64 + 64
//     bytes apart, and a producer stores its two 16-byte halves in the
//     order ((e >> 2) & 1) of its item, so each quarter-warp's conversion
//     stores hit 8 distinct bank groups (a CPU test holds both).
//   Forward: the columns are the 8 parities x Co (column p * Co + co) in
//     groups of NCOL, each column group's weights resident in shared
//     memory as fp64 for the whole launch ([Ci / 8][NCOL][8], 128 KB at
//     most: NCOL x Ci <= 16384), converted once by the block at its start.
//     At 64 -> 32 NCOL = 256 = all of them, tiles of 32 voxels, so every x
//     byte is read once; at 128 -> 64 NCOL = 128, the four (a, b) pairs in
//     four groups of blocks that walk the same tiles at the same time, so x
//     (34 MB, which the 50 MB L2 can hold) is read four times. A step is KC
//     channels of the tile's x.
//   dx: the columns are NCOL of the Ci input channels (all of them at the
//     flagship's shapes, so every gy byte is read once), K = 8 parities x
//     Co in steps of one parity x KC output channels: the tile's gy rows at
//     fine voxel 2q + p (one 128- or 64-byte piece of a fine voxel each),
//     and the weights wf[p, ci tile, co chunk] as B (KC x NCOL), both
//     converted once a step. A producer decodes its rows' fine voxels once
//     a tile (two multiply-shift divisions a row); a step only adds its
//     parity's offset.
//   Staged epilogue. Each MMA warp rounds its 32 x 32 tile to fp32 into a
//     shared-memory tile of its own (row pitch 40 floats: its float2 stores
//     and float4 reads hit 32 banks) and stores it as whole 16-byte pieces,
//     8 lanes a row: 128 contiguous bytes of a fine voxel's channels (the
//     forward: voxel 2q + p of the warp's parity, stored evict-first so
//     that y does not push x out of L2) or of a coarse voxel's (dx).
//   Measured on an H100 (PERF.md §6): both at ~40 TFLOP/s at the flagship's
//     shapes, bound by shared-memory traffic rather than by the tensor
//     cores or HBM: dx runs as long with its MMAs removed and 12% faster
//     without its conversions, the forward keeps 65% of its time without
//     MMAs (the fragment loads, 512 bytes an MMA, remain).
//
// dW: GEMMs over f32gemm::Tile, 4 warps a block (f32_gemm.cuh): M = Ci
//   tile, N = Co tile, K = all coarse voxels of the batch in chunks of 32,
//   one parity a block, split across blocks; each split stores its (8, Ci,
//   Co) partial to its own slice and split_sums_finish adds them in split
//   order.
//
// Requirements (checked by the wrappers and here): Ci % 32 == 0, Co % 32 ==
// 0, contiguous 16-byte aligned operands, N * 8 * D * H * W < 2^31; the
// forward Ci <= 512; the launchers refuse a plan (column group, blocks,
// shared memory) that is not their own.
#include "f32_gemm.cuh"

namespace up32 {

using f32gemm::dmma;
using f32gemm::fdiv;
using f32gemm::FastDiv;

constexpr int MMA_THREADS = 256;  // the 8 MMA warps
constexpr int PRODUCERS = 128;    // the 4 warps that copy and convert
constexpr int BLOCK = MMA_THREADS + PRODUCERS;
// named barriers (0 is __syncthreads): the fp64 buffers' "full" and
// "empty" (NF of each), the producers alone
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5;
constexpr int NST = 3;  // fp32 ring stages: copies run 2 steps ahead
constexpr int NF = 2;   // fp64 buffers
constexpr int SP = 40;  // row pitch (floats) of a warp's staged outputs
constexpr int STAGED = 32 * SP;  // floats of a warp's staged 32 x 32 tile
constexpr int FWD_W_MAX = 16384;  // NCOL x Ci of the resident weights

// -- the PTX primitives --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// -- end of the PTX primitives --

struct Args {
  const float* a;   // forward: x (N, D, H, W, Ci); dx: gy (N, 2D, 2H, 2W, Co)
  const float* wf;  // (2, 2, 2, Ci, Co)
  float* out;       // y or dx
  int N, D, H, W, Ci, Co;
  int V;            // coarse voxels, N * D * H * W
  int tiles;        // ceil(V / M)
  FastDiv fw, fh;   // W, H
};

// the fine voxel 2q + p of coarse voxel v (flat (n, d, h, w)), as an index
// into the (N, 2D, 2H, 2W) volume
__device__ __forceinline__ int fine_of(const Args& a, int v, int p) {
  const int r = fdiv(v, a.fw);   // (n * D + d) * H + h
  const int w = v - r * a.W;
  const int nd = fdiv(r, a.fh);  // n * D + d
  const int h = r - nd * a.H;
  return ((2 * nd + (p >> 2)) * 2 * a.H + 2 * h + ((p >> 1) & 1)) * 2 * a.W +
         2 * w + (p & 1);
}

// The tile of the MMA warps: warp w owns rows (w % WGM) * 32 and columns
// (w / WGM) * 32 of an M x NCOL output tile.
template <int NCOL_>
struct Warps {
  static constexpr int NCOL = NCOL_;
  static constexpr int WGN = NCOL / 32, WGM = 8 / WGN, M = 32 * WGM;
  static_assert(WGN * WGM == 8, "8 MMA warps");
};

// The double offset of channel group kk (of 8), row r of an fp64 buffer of
// R rows: planes R * 64 + 64 bytes apart.
template <int R>
__host__ __device__ constexpr int plane(int kk) {
  return kk * (R * 8 + 8);
}

// Converts R rows x KC fp32 channels (a ring slot, rows contiguous, as the
// copies land) once into the fp64 buffer [KC / 8][R][8]. Item e = (row e /
// (KC / 4), 16-byte piece e % (KC / 4)); its two fp64 halves are stored in
// the order (e >> 2) & 1, so a quarter-warp's stores hit 8 bank groups.
template <int R, int KC>
__device__ __forceinline__ void convert_rows(const float* src, double* dst,
                                             int pt) {
  constexpr int PR = KC / 4, ITEMS = R * PR;
  static_assert(ITEMS % PRODUCERS == 0, "whole items a producer");
#pragma unroll
  for (int i = 0; i < ITEMS / PRODUCERS; ++i) {
    const int e = pt + i * PRODUCERS;
    const int r = e / PR, j = e % PR;
    const float4 v = reinterpret_cast<const float4*>(src)[e];
    double* d = dst + plane<R>(j >> 1) + r * 8 + 4 * (j & 1);
    const int h = (e >> 2) & 1;
    const double2 lo = make_double2(v.x, v.y), hi = make_double2(v.z, v.w);
    *reinterpret_cast<double2*>(d + 2 * h) = h ? hi : lo;
    *reinterpret_cast<double2*>(d + 2 - 2 * h) = h ? lo : hi;
  }
}

// acc += one k-step of 8 channels: A rows (32 of the warp) at ap, B columns
// (32 of the warp) at bp, both [row][8 channels]
__device__ __forceinline__ void kstep(double (&acc)[2][4][4],
                                      const double* ap, const double* bp,
                                      int g, int t) {
  double af[2][4], bf[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const double2 lo =
        *reinterpret_cast<const double2*>(ap + (mi * 16 + g) * 8 + 2 * t);
    const double2 hi =
        *reinterpret_cast<const double2*>(ap + (mi * 16 + g + 8) * 8 + 2 * t);
    af[mi][0] = lo.x;
    af[mi][1] = hi.x;
    af[mi][2] = lo.y;
    af[mi][3] = hi.y;
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const double2 b =
        *reinterpret_cast<const double2*>(bp + (ni * 8 + g) * 8 + 2 * t);
    bf[ni][0] = b.x;
    bf[ni][1] = b.y;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) dmma(acc[mi][ni], af[mi], bf[ni]);
}

__device__ __forceinline__ void zero(double (&acc)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;
}

// Rounds the warp's sums to fp32 into its staged tile st (rows 32, pitch
// SP) and hands each of the lane's 8 pieces, row r = (lane >> 3) + 4s and
// channels 4 (lane & 7) .. + 3, to store(r, piece).
template <class F>
__device__ __forceinline__ void staged_epilogue(const double (&acc)[2][4][4],
                                                float* st, int lane,
                                                F&& store) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // the previous tile's reads are done
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(st + (mi * 16 + g + 8 * h) * SP + ni * 8 +
                                   2 * t) =
            make_float2((float)acc[mi][ni][2 * h],
                        (float)acc[mi][ni][2 * h + 1]);
  __syncwarp();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int r = (lane >> 3) + 4 * s;
    store(r, *reinterpret_cast<const float4*>(st + r * SP + 4 * (lane & 7)));
  }
}

// ---------------------------------------------------------------- forward

template <int NCOL>
struct Fwd : Warps<NCOL> {
  using B = Warps<NCOL>;
  static constexpr int M = B::M;
  static constexpr int KC = NCOL >= 128 ? 32 : NCOL / 4;  // M x KC <= 2048
  static constexpr int A64 = plane<M>(KC / 8);  // doubles an fp64 buffer
  static constexpr int A32 = M * KC;            // floats a ring slot
  // shared memory: the resident weights, NF fp64 buffers, NST fp32 slots,
  // the 8 warps' staged outputs
  static constexpr size_t smem(int ci) {
    return (size_t)NCOL * ci * 8 + (size_t)NF * A64 * 8 +
           (size_t)NST * A32 * 4 + (size_t)8 * STAGED * 4;
  }
};

// the entries are named as the wrappers count their launches
template <int NCOL>
__global__ void __launch_bounds__(BLOCK, 1)
    upsample2x_f32(const __grid_constant__ Args a) {
  using C = Fwd<NCOL>;
  constexpr int M = C::M, KC = C::KC, PR = KC / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  double* wres = reinterpret_cast<double*>(smem);
  double* a64 = wres + (size_t)NCOL * a.Ci;
  float* a32 = reinterpret_cast<float*>(a64 + NF * C::A64);
  float* stg = a32 + NST * C::A32;
  const int grp = blockIdx.y;
  const int t0 = (int)((long long)blockIdx.x * a.tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * a.tiles / gridDim.x);
  const int cps = a.Ci / KC;  // steps a tile
  const int steps = (t1 - t0) * cps;
  if (steps <= 0) return;
  const int pt = threadIdx.x - MMA_THREADS;

  // the producers' copies of step j (tile t0 + j / cps, channels kc * KC):
  // the tile's x rows, consecutive voxels
  int ct = t0, ckc = 0;  // the step copied next
  auto issue = [&](int j) {
    const uint32_t dst = smem_u32(a32 + (j % NST) * C::A32);
    const float* base = a.a + (size_t)ct * M * a.Ci + ckc * KC;
    const int left = a.V - ct * M;
#pragma unroll
    for (int i = 0; i < M * PR / PRODUCERS; ++i) {
      const int e = pt + i * PRODUCERS, r = e / PR;
      const bool in = r < left;
      cp16(dst + e * 16, in ? base + (size_t)r * a.Ci + 4 * (e % PR) : a.a,
           in);
    }
    if (++ckc == cps) ckc = 0, ++ct;
  };
  if (threadIdx.x >= MMA_THREADS) {
#pragma unroll
    for (int j = 0; j < NST - 1; ++j) {
      if (j < steps) issue(j);
      cp_commit();
    }
  }
  // the column group's weights, once: wres[ci / 8][c][ci % 8] = wf[p, ci,
  // co] for column grp * NCOL + c = p * Co + co (two ci a thread, read
  // along co)
  for (int e = threadIdx.x; e < NCOL * a.Ci / 2; e += BLOCK) {
    const int c = e % NCOL, ci = 2 * (e / NCOL);
    const int col = grp * NCOL + c, p = col / a.Co, co = col - p * a.Co;
    const float* src = a.wf + ((size_t)p * a.Ci + ci) * a.Co + co;
    *reinterpret_cast<double2*>(wres + ((ci >> 3) * NCOL + c) * 8 +
                                (ci & 7)) =
        make_double2(__ldg(src), __ldg(src + a.Co));
  }
  __syncthreads();

  if (threadIdx.x >= MMA_THREADS) {
    for (int j = 0; j < steps; ++j) {
      cp_wait<NST - 2>();              // this thread's copies of step j
      bar_sync(BAR_PROD, PRODUCERS);   // everyone's; step j - 1 converted
      if (j + NST - 1 < steps) issue(j + NST - 1);
      cp_commit();
      if (j >= NF) bar_sync(BAR_EMPTY + j % NF, BLOCK);
      convert_rows<M, KC>(a32 + (j % NST) * C::A32, a64 + (j % NF) * C::A64,
                          pt);
      bar_arrive(BAR_FULL + j % NF, BLOCK);
    }
    return;
  }

  // the MMA warps: warp (wm, wn), its columns one parity's 32 channels
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % C::WGM, wn = warp / C::WGM;
  const int g = lane >> 2, t = lane & 3;
  const int colb = grp * NCOL + wn * 32;
  const int p = colb / a.Co, co0 = colb - p * a.Co;
  float* st = stg + warp * STAGED;
  double acc[2][4][4];
  zero(acc);
  int tile = t0, kc = 0;
  for (int j = 0; j < steps; ++j) {
    bar_sync(BAR_FULL + j % NF, BLOCK);
    const double* ab = a64 + (j % NF) * C::A64 + wm * 32 * 8;
    const double* wb = wres + ((size_t)kc * (KC / 8) * NCOL + wn * 32) * 8;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk)
      kstep(acc, ab + plane<M>(kk), wb + kk * NCOL * 8, g, t);
    if (j + NF < steps) bar_arrive(BAR_EMPTY + j % NF, BLOCK);
    if (++kc == cps) {
      const int v0 = tile * M + wm * 32;
      staged_epilogue(acc, st, lane, [&](int r, float4 v) {
        if (v0 + r < a.V)
          __stcs(reinterpret_cast<float4*>(
                     a.out + (size_t)fine_of(a, v0 + r, p) * a.Co + co0 +
                     4 * (lane & 7)),
                 v);
      });
      zero(acc);
      kc = 0;
      ++tile;
    }
  }
}

// -------------------------------------------------------------------- dx

template <int NCOL>
struct Dx : Warps<NCOL> {
  using B = Warps<NCOL>;
  static constexpr int M = B::M;
  static constexpr int KC = NCOL == 32 ? 16 : 32;  // M x KC <= 4096
  static constexpr int A64 = plane<M>(KC / 8), B64 = plane<NCOL>(KC / 8);
  static constexpr int A32 = M * KC, B32 = NCOL * KC;
  // shared memory: NF fp64 gy and weight buffers, NST fp32 slots of both,
  // the 8 warps' staged outputs
  static constexpr size_t SMEM = (size_t)NF * (A64 + B64) * 8 +
                                 (size_t)NST * (A32 + B32) * 4 +
                                 (size_t)8 * STAGED * 4;
  static_assert(SMEM <= 232448, "227 KB");
};

template <int NCOL>
__global__ void __launch_bounds__(BLOCK, 1)
    upsample2x_dx_f32(const __grid_constant__ Args a) {
  using C = Dx<NCOL>;
  constexpr int M = C::M, KC = C::KC, PR = KC / 4;
  constexpr int AI = M * PR / PRODUCERS;     // gy items a producer
  constexpr int BI = NCOL * PR / PRODUCERS;  // weight items a producer
  extern __shared__ __align__(16) unsigned char smem[];
  double* a64 = reinterpret_cast<double*>(smem);
  double* b64 = a64 + NF * C::A64;
  float* ring = reinterpret_cast<float*>(b64 + NF * C::B64);
  float* stg = ring + NST * (C::A32 + C::B32);
  const int ci0 = blockIdx.y * NCOL;
  const int t0 = (int)((long long)blockIdx.x * a.tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * a.tiles / gridDim.x);
  const int ccs = a.Co / KC;  // channel chunks a parity
  const int spt = 8 * ccs;    // steps a tile
  const int steps = (t1 - t0) * spt;
  if (steps <= 0) return;

  if (threadIdx.x >= MMA_THREADS) {
    const int pt = threadIdx.x - MMA_THREADS;
    // the step copied next: tile ct, parity cp, chunk cc; fb: the fine
    // voxel at parity 0 of this producer's gy rows in tile ct (-1 past the
    // last voxel)
    int ct = t0, cp = 0, cc = 0;
    int fb[AI];
    auto rows_of = [&]() {
#pragma unroll
      for (int i = 0; i < AI; ++i) {
        const int v = ct * M + (pt + i * PRODUCERS) / PR;
        fb[i] = v < a.V ? fine_of(a, v, 0) : -1;
      }
    };
    rows_of();
    auto issue = [&](int j) {
      float* slot = ring + (j % NST) * (C::A32 + C::B32);
      const uint32_t da = smem_u32(slot), db = smem_u32(slot + C::A32);
      const int off = ((cp >> 2) * 2 * a.H + ((cp >> 1) & 1)) * 2 * a.W +
                      (cp & 1);
      const float* gy = a.a + cc * KC;
#pragma unroll
      for (int i = 0; i < AI; ++i) {
        const int e = pt + i * PRODUCERS;
        const bool in = fb[i] >= 0;
        cp16(da + e * 16,
             in ? gy + (size_t)(fb[i] + off) * a.Co + 4 * (e % PR) : a.a,
             in);
      }
      // B[k = co][n = ci] = wf[p, ci0 + r, cc * KC + k]: rows r of KC
      const float* w =
          a.wf + ((size_t)cp * a.Ci + ci0) * a.Co + cc * KC;
#pragma unroll
      for (int i = 0; i < BI; ++i) {
        const int e = pt + i * PRODUCERS;
        cp16(db + e * 16, w + (size_t)(e / PR) * a.Co + 4 * (e % PR), true);
      }
      if (++cc < ccs) return;
      cc = 0;
      if (++cp < 8) return;
      cp = 0;
      ++ct;
      rows_of();
    };
#pragma unroll
    for (int j = 0; j < NST - 1; ++j) {
      if (j < steps) issue(j);
      cp_commit();
    }
    for (int j = 0; j < steps; ++j) {
      cp_wait<NST - 2>();
      bar_sync(BAR_PROD, PRODUCERS);
      if (j + NST - 1 < steps) issue(j + NST - 1);
      cp_commit();
      if (j >= NF) bar_sync(BAR_EMPTY + j % NF, BLOCK);
      const float* slot = ring + (j % NST) * (C::A32 + C::B32);
      convert_rows<M, KC>(slot, a64 + (j % NF) * C::A64, pt);
      convert_rows<NCOL, KC>(slot + C::A32, b64 + (j % NF) * C::B64, pt);
      bar_arrive(BAR_FULL + j % NF, BLOCK);
    }
    return;
  }

  // the MMA warps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % C::WGM, wn = warp / C::WGM;
  const int g = lane >> 2, t = lane & 3;
  float* st = stg + warp * STAGED;
  double acc[2][4][4];
  zero(acc);
  int tile = t0, s = 0;
  for (int j = 0; j < steps; ++j) {
    bar_sync(BAR_FULL + j % NF, BLOCK);
    const double* ab = a64 + (j % NF) * C::A64 + wm * 32 * 8;
    const double* bb = b64 + (j % NF) * C::B64 + wn * 32 * 8;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk)
      kstep(acc, ab + plane<M>(kk), bb + plane<NCOL>(kk), g, t);
    if (j + NF < steps) bar_arrive(BAR_EMPTY + j % NF, BLOCK);
    if (++s == spt) {
      const int v0 = tile * M + wm * 32;
      float* out = a.out + (size_t)v0 * a.Ci + ci0 + wn * 32 + 4 * (lane & 7);
      staged_epilogue(acc, st, lane, [&](int r, float4 v) {
        if (v0 + r < a.V)
          *reinterpret_cast<float4*>(out + (size_t)r * a.Ci) = v;
      });
      zero(acc);
      s = 0;
      ++tile;
    }
  }
}

template <class K>
int launch(K kernel, dim3 grid, size_t smem, const Args& a,
           cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, BLOCK, smem, st>>>(a);
  return (int)cudaGetLastError();
}

bool shape_ok(int N, int D, int H, int W, int Ci, int Co) {
  return N >= 1 && D >= 1 && H >= 1 && W >= 1 && Ci % 32 == 0 &&
         Co % 32 == 0 && Ci >= 32 && Co >= 32 &&
         (long long)N * 8 * D * H * W < (1ll << 31);
}

Args args(const void* in, const void* wf, void* out, int N, int D, int H,
          int W, int Ci, int Co, int m) {
  Args a{};
  a.a = static_cast<const float*>(in);
  a.wf = static_cast<const float*>(wf);
  a.out = static_cast<float*>(out);
  a.N = N, a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co;
  a.V = N * D * H * W;
  a.tiles = (a.V + m - 1) / m;
  a.fw = f32gemm::fast_div((unsigned)W);
  a.fh = f32gemm::fast_div((unsigned)H);
  return a;
}

template <int NCOL>
int fwd(const void* x, const void* wf, void* y, int N, int D, int H, int W,
        int Ci, int Co, int grid, int smem, cudaStream_t st) {
  using C = Fwd<NCOL>;
  static_assert(C::smem(FWD_W_MAX / NCOL) <= 232448, "227 KB");
  if ((size_t)smem != C::smem(Ci) || NCOL * Ci > FWD_W_MAX)
    return (int)cudaErrorInvalidValue;
  const Args a = args(x, wf, y, N, D, H, W, Ci, Co, C::M);
  if (grid < 1 || grid > a.tiles) return (int)cudaErrorInvalidValue;
  return launch(upsample2x_f32<NCOL>, dim3(grid, 8 * Co / NCOL), smem, a,
                st);
}

template <int NCOL>
int dx(const void* gy, const void* wf, void* out, int N, int D, int H,
       int W, int Ci, int Co, int grid, int smem, cudaStream_t st) {
  using C = Dx<NCOL>;
  if ((size_t)smem != C::SMEM || Ci % NCOL) return (int)cudaErrorInvalidValue;
  const Args a = args(gy, wf, out, N, D, H, W, Ci, Co, C::M);
  if (grid < 1 || grid > a.tiles) return (int)cudaErrorInvalidValue;
  return launch(upsample2x_dx_f32<NCOL>, dim3(grid, Ci / NCOL), smem, a, st);
}

}  // namespace up32

namespace {

using namespace f32gemm;

struct UpArgs {
  const float* a;  // x (N, D, H, W, Ci)
  const float* b;  // gy
  float* out;      // dW, or its (splits, 8, Ci, Co) partials
  int N, D, H, W, Ci, Co;
  int nch, splits;     // K chunks of 32 coarse voxels, their splits
  FastDiv vox, hw, w;  // D*H*W, H*W, W
};

template <class T>
struct UpDwOp {
  const UpArgs* a;
  int p, ci0, n0, K;

  __device__ UpDwOp(const UpArgs& a_, int p_, int ct, int nt)
      : a(&a_), p(p_) {
    ci0 = ct * T::BM;
    n0 = nt * T::BN;
    K = a_.N * a_.D * a_.H * a_.W;
  }

  __device__ void load(int s, float4 (&ra)[T::A_LOADS],
                       float4 (&rb)[T::B_LOADS]) const {
    const int v0 = s * BK;
    // A[k = coarse voxel][m = ci]
#pragma unroll
    for (int j = 0; j < T::A_LOADS; ++j) {
      const int v = v0 + T::a_row(j);
      ra[j] = v < K ? ld4(a->a + (long long)v * a->Ci + ci0 + 4 * T::a_c4(j))
                    : zero4();
    }
    // B[k = coarse voxel q][n = co] = gy[2q + p, co]
#pragma unroll
    for (int j = 0; j < T::B_LOADS; ++j) {
      float4 g = zero4();
      const int v = v0 + T::b_row(j);
      if (v < K) {
        const int n = fdiv(v, a->vox), r = v - n * (int)a->vox.d;
        const int qd = fdiv(r, a->hw), rr = r - qd * (int)a->hw.d;
        const int qh = fdiv(rr, a->w), qw = rr - qh * (int)a->w.d;
        const long long f =
            (((long long)n * 2 * a->D + 2 * qd + (p >> 2)) * 2 * a->H + 2 * qh +
             ((p >> 1) & 1)) * 2 * a->W + 2 * qw + (p & 1);
        g = ld4(a->b + f * a->Co + n0 + 4 * T::b_c4(j));
      }
      rb[j] = g;
    }
  }
};

template <class T>
__global__ void __launch_bounds__(THREADS)
    upsample2x_dw_f32(const __grid_constant__ UpArgs a) {
  __shared__ __align__(16) float smem[T::SMEM_FLOATS];
  const int cts = a.Ci / T::BM;
  const int p = blockIdx.x / cts, ct = blockIdx.x % cts;
  const int nt = blockIdx.y, sp = blockIdx.z;
  const int s0 = (int)((long long)sp * a.nch / a.splits);
  const int s1 = (int)((long long)(sp + 1) * a.nch / a.splits);
  double acc[T::MT][T::NT][4];
  const UpDwOp<T> op(a, p, ct, nt);
  gemm<T>(op, smem, s0, s1, acc);
  float* out = a.out + ((long long)sp * 8 + p) * a.Ci * a.Co;
  T::for_pairs(acc, [&](int m, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(
        out + (long long)(ct * T::BM + m) * a.Co + nt * T::BN + c) =
        make_float2(v0, v1);
  });
}

using DwWW = Tile<64, 64, true, true>;  // dW: bm x bn
using DwWN = Tile<64, 32, true, true>;
using DwNW = Tile<32, 64, true, true>;
using DwNN = Tile<32, 32, true, true>;

}  // namespace

// y (N, 2D, 2H, 2W, Co) from x (N, D, H, W, Ci) and the flipped wf (2, 2,
// 2, Ci, Co) (ops/upsample.py _up_f32_fwd_plan): columns (parity, co) in
// groups of ncol (256, 128, 64 or 32; ncol x Ci <= 16384), `grid` blocks a
// group walking the tiles of 8192 / ncol voxels; smem must be the
// configuration's at this Ci.
extern "C" int upsample2x_f32_launch(const void* x, const void* wf, void* y,
                                     int N, int D, int H, int W, int Ci,
                                     int Co, int ncol, int grid, int smem,
                                     void* stream) {
  if (!up32::shape_ok(N, D, H, W, Ci, Co)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ncol) {
    case 256:
      return up32::fwd<256>(x, wf, y, N, D, H, W, Ci, Co, grid, smem, st);
    case 128:
      return up32::fwd<128>(x, wf, y, N, D, H, W, Ci, Co, grid, smem, st);
    case 64:
      return up32::fwd<64>(x, wf, y, N, D, H, W, Ci, Co, grid, smem, st);
    case 32:
      return up32::fwd<32>(x, wf, y, N, D, H, W, Ci, Co, grid, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dx (N, D, H, W, Ci) from gy (N, 2D, 2H, 2W, Co) and wf
// (_up_f32_dx_plan): ncol (128, 64 or 32) input channels a column group,
// `grid` blocks a group walking the tiles of 8192 / ncol voxels; smem must
// be the configuration's.
extern "C" int upsample2x_f32_dx_launch(const void* gy, const void* wf,
                                        void* dx, int N, int D, int H, int W,
                                        int Ci, int Co, int ncol, int grid,
                                        int smem, void* stream) {
  if (!up32::shape_ok(N, D, H, W, Ci, Co)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ncol) {
    case 128:
      return up32::dx<128>(gy, wf, dx, N, D, H, W, Ci, Co, grid, smem, st);
    case 64:
      return up32::dx<64>(gy, wf, dx, N, D, H, W, Ci, Co, grid, smem, st);
    case 32:
      return up32::dx<32>(gy, wf, dx, N, D, H, W, Ci, Co, grid, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dwf (2, 2, 2, Ci, Co) fp32 from x and gy; bm 64 (Ci % 64 == 0) or 32,
// bn 64 (Co % 64 == 0) or 32; part: (splits, 8, Ci, Co) scratch, null at
// one split (dW written directly).
extern "C" int upsample2x_f32_dw_launch(const void* x, const void* gy,
                                        void* dw, void* part, int N, int D,
                                        int H, int W, int Ci, int Co, int bm,
                                        int bn, int splits, void* stream) {
  if (!up32::shape_ok(N, D, H, W, Ci, Co) || !(bm == 32 || bm == 64) ||
      Ci % bm || !(bn == 32 || bn == 64) || Co % bn || splits < 1 ||
      (splits > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  UpArgs a{};
  a.a = static_cast<const float*>(x);
  a.b = static_cast<const float*>(gy);
  a.out = static_cast<float*>(splits > 1 ? part : dw);
  a.N = N, a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co;
  const int K = N * D * H * W;
  a.nch = (K + BK - 1) / BK;
  if (splits > a.nch) return (int)cudaErrorInvalidValue;
  a.splits = splits;
  a.vox = fast_div((unsigned)(D * H * W));
  a.hw = fast_div((unsigned)(H * W));
  a.w = fast_div((unsigned)W);
  const dim3 grid(8 * (Ci / bm), Co / bn, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 64) {
    if (bn == 64) upsample2x_dw_f32<DwWW><<<grid, THREADS, 0, st>>>(a);
    else upsample2x_dw_f32<DwWN><<<grid, THREADS, 0, st>>>(a);
  } else {
    if (bn == 64) upsample2x_dw_f32<DwNW><<<grid, THREADS, 0, st>>>(a);
    else upsample2x_dw_f32<DwNN><<<grid, THREADS, 0, st>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long len = 8LL * Ci * Co;
  split_sums_finish<<<(unsigned)((len + THREADS - 1) / THREADS), THREADS, 0,
                      st>>>(a.out, static_cast<float*>(dw), len, splits);
  return (int)cudaGetLastError();
}
