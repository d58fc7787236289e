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
// output's only error is its final rounding to fp32. No atomics: two runs
// are bit-equal. Not the split-precision TF32 route ("3xTF32": hi/lo tf32
// halves, three products on the TF32 tensor cores): its products are as
// good (2e-7 to 9e-7 relative L2 against fp64 at the flagship's shapes),
// but the TF32 tensor cores' fp32 accumulation truncates, and where an
// input has a large mean (the pre-op'd activations) the truncations line
// up across voxels: on an H100 the [sum] statistic of a 64^3 x 64 conv
// moved by 2.5e-5 of its scale (PERF.md §6), over the 1e-5 the fp32
// kernels are held to. The card's dense FP64 tensor-core peak is 67
// TFLOP/s against 165 for 3xTF32 (494.7 / 3); the sm_90 shape m16n8k8 ran
// these kernels faster than the older m8n8k4 (PERF.md §6).
//
// What bounds them on the H100 (per launch at N = 2, each the same for the
// forward, dx and dW): 128 -> 64 from 32^3 does 8.6 GFLOP, 128 us at the
// FP64 tensor cores' 67 TFLOP/s, against 168 MB, 50 us of HBM; 64 -> 32
// from 64^3 does 17.2 GFLOP, 256 us, against 671 MB, 200 us (y, or gy, is
// four fifths of the bytes). So all three are bound by the FP64 tensor
// cores, with bytes close behind at 64 -> 32. At that rate an SM takes one
// m16n8k8 (1,024 FMAs) every ~8 cycles and reads 128 bytes of shared
// memory a cycle, so each fragment byte has to serve several MMAs from
// registers and each operand is converted to fp64 once, not at every
// fragment read.
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
// dW (conv3d_k3_f32_dw.cu's units, the 27 taps replaced by the 8
// parities):
//   Units. A unit is all 8 parities x DW_CO = 32 output channels x CI
//     input channels (64, or 32 where Ci % 64 != 0) over a range of the
//     batch's steps. A step is DW_R = 16 coarse voxels along w of one (n,
//     d, h) row: x's 16 rows of CI channels and, for each (a, b), gy's fine
//     row of 32 voxels (both w-parities c, interleaved) x 32 channels, each
//     a contiguous run of global memory, zero-filled past W. The GEMM's M
//     is co (gy the A operand), N ci (x the B operand), K the step's
//     voxels in 2 MMA k of 8.
//   Warps. 8 MMA warps and 8 producer warps, 512 threads, one block an
//     SM. MMA warp w holds the 2 parities (a, b) = w % 4, c = 0, 1 x the 2
//     m-tiles of 16 co x NT = CI / 16 n-tiles of 8 ci (ci half w / 4): 16
//     MMA tiles, 64 fp64 sums a thread at CI = 64. The launch gives every
//     thread 128 registers; setmaxnreg (sm_90a) then moves the producer
//     warpgroups to 40 and the MMA warpgroups to 216. Measured on an H100
//     (PERF.md §6): with the forward's 4 producer warps the producers bound
//     it (as long without MMAs, a quarter faster without either copies or
//     conversion) and 64 sums at 168 registers spilled; 8 producer warps
//     and 216 registers for the MMA warps brought it to 4-8% above its
//     time with the producers idle.
//   Shared bytes per MMA. A warp's k-step loads 2 x 2 A fragments (16 co x
//     8 voxels, 1 KB each) and NT B fragments (8 voxels x 8 ci, 512 B) for
//     4 NT MMAs: 1024 / NT + 512 / 4 = 384 B an MMA at CI = 64 (the forward
//     and dx: 512 at their 32 x 32 warp tiles). The producers write each
//     staged element to an fp32 slot (cp.async), read it and write it to
//     the fp64 buffers once: a k-step stages 8 x (CI + 8 x 32) = 2,560
//     elements for 128 MMAs at CI = 64, 20 an MMA, 320 B more (4 + 4 + 8 an
//     element): ~700 B an MMA in all, against the 1,024 that 128 B a cycle
//     allow at one MMA every 8 cycles.
//   Convert once. A staged x element serves the 8 parities' 2 m-tiles (16
//     MMAs), a gy element the CI / 8 n-tiles; each is converted once by a
//     producer, into fp64 buffers [k][ci][8 voxels] (x) and
//     [k][parity][co][8 voxels] (gy), so that a lane's fragment pair
//     (voxels 2t and 2t + 1, which are MMA k = t and t + 4) is one 16-byte
//     load and a quarter-warp reads 128 contiguous bytes (channel c's row
//     is crow(c): an odd quad of channels in the order 1, 0, 3, 2, so a
//     quarter-warp's conversion stores, 4 voxel pairs x 2 quads, hit 8 bank
//     groups; the MMA warps read the same rows). The conversion
//     de-interleaves c: a gy item is 4 fine voxels (2 coarse voxels x c) x
//     4 co, read as 4 float4 and stored as 8 fp64 pairs; an x item 2 voxels
//     x 4 ci, 2 float4 read, 4 pairs stored. The fp32 slots' 16-byte pieces
//     are XOR-swizzled (x by bits 1-2 of the voxel, gy by bits 2-3 of the
//     fine voxel), so every quarter-warp's conversion loads hit the 8 bank
//     groups once too (a CPU test holds each access). The producers walk
//     the steps with a cursor over (n, d, h) rows, no division in a step,
//     and copy a step whose 16 voxels lie inside the volume without a
//     bounds test.
//   Splits. The (ci, co) tiles number 1 to 4 at the flagship's shapes, so
//     the steps are split into ranges to fill the card: unit u = split x
//     tiles + co tile x ci tiles + ci tile, one block a unit, the tiles of
//     a split on neighbouring blocks so that a step's x and gy come from
//     HBM once. A unit stores its fp64 sums to its split's slice of a
//     (splits, 8, Ci, Co) scratch; upsample2x_dw_f32_split_finish adds the
//     slices in split order and rounds once to fp32.
//
// Requirements (checked by the wrappers and here): Ci % 32 == 0, Co % 32 ==
// 0, contiguous 16-byte aligned operands, N * 8 * D * H * W < 2^31; the
// forward Ci <= 512; the launchers refuse a plan (column group, blocks,
// shared memory; dW's ci tile, splits, grid, shared memory, scratch length
// and finish grid) that is not their own.
#include <cstdint>

#include <cuda_runtime.h>

namespace up32 {

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

// a warpgroup's registers a thread set to N (sm_90a): released by the
// producers, taken by the MMA warpgroups
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// c += a * b on the FP64 tensor cores: a 16 x 8 row-major fragment (lane
// (g, t) holds a[g][t], a[g + 8][t], a[g][t + 4], a[g + 8][t + 4]), b 8 x 8
// col-major (b[t][g], b[t + 4][g]), c 16 x 8 (c[g][2t], c[g][2t + 1],
// c[g + 8][2t], c[g + 8][2t + 1])
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
// -- end of the PTX primitives --

// n / d for 0 <= n < 2^31 by multiply and shift (PyTorch's IntDivider), d
// set on the host
struct FastDiv {
  unsigned d, m, s;
};

inline FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned m = (unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  return FastDiv{d, m, s};
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return (int)((__umulhi((unsigned)n, f.m) + (unsigned)n) >> f.s);
}

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

template <class K, class A>
int launch(K kernel, dim3 grid, size_t smem, const A& a, cudaStream_t st,
           int threads = BLOCK) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, st>>>(a);
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
  a.fw = fast_div((unsigned)W);
  a.fh = fast_div((unsigned)H);
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

// -------------------------------------------------------------------- dW

constexpr int DW_R = 16;         // coarse voxels a step, along w
constexpr int DW_KS = DW_R / 8;  // MMA k-steps a step
constexpr int DW_CO = 32;        // output channels of a tile
constexpr int DW_FIN = 256;      // threads a block of the split finish
constexpr int DW_PRODUCERS = 256;  // the 8 warps that copy and convert
constexpr int DW_BLOCK = MMA_THREADS + DW_PRODUCERS;
// registers a thread: the kernel's (its launch bounds' most), then the two
// producer warpgroups' and the two MMA warpgroups' after setmaxnreg, which
// hands the producers' spare registers to the MMA warps' 128 of sums
constexpr int DW_REGS = 65536 / DW_BLOCK;
constexpr int DW_PROD_REGS = 40, DW_MMA_REGS = 216;
static_assert(DW_PRODUCERS * (DW_REGS - DW_PROD_REGS) ==
                  MMA_THREADS * (DW_MMA_REGS - DW_REGS),
              "the MMA warps take what the producers release");

// The dW tile of CI input channels: the fp64 buffers x [k][ci][8 voxels]
// and gy [k][parity][co][8 voxels], channel c in row crow(c); an fp32 slot
// x [voxel][CI] and gy [(a, b)][fine w][DW_CO], their 16-byte pieces
// swizzled (xpiece, gpiece)
template <int CI_>
struct Dw {
  static constexpr int CI = CI_;
  static constexpr int NT = CI / 16;  // a warp's n-tiles of 8 ci
  static constexpr int X64 = DW_KS * CI * 8;
  static constexpr int G64 = DW_KS * 8 * DW_CO * 8;
  static constexpr int X32 = DW_R * CI;
  static constexpr int G32 = 4 * 2 * DW_R * DW_CO;
  static constexpr int SLOT = X32 + G32;
  static constexpr int XQ = CI / 4;                  // pieces of an x row
  static constexpr int XC = DW_R * XQ;               // x copies a step
  static constexpr int GC = G32 / 4;                 // gy copies a step
  static constexpr int XI = DW_R / 2 * XQ;           // x conversion items
  static constexpr int GI = 4 * DW_R / 2 * (DW_CO / 4);  // gy items
  static constexpr size_t SMEM =
      (size_t)NF * (X64 + G64) * 8 + (size_t)NST * SLOT * 4;
  static_assert(GC % DW_PRODUCERS == 0 && GI % DW_PRODUCERS == 0 &&
                    DW_PRODUCERS == 16 * DW_R,
                "whole gy copies and items a producer; a producer's k-th "
                "gy copy is of pair k");
  static_assert(SMEM <= 232448, "227 KB");
};

// the float offset, in a slot, of x's piece jq (4 ci) of voxel v, and of
// gy's piece cq (4 co) of fine voxel jf of pair ab
template <int CI>
__host__ __device__ constexpr int xpiece(int v, int jq) {
  return v * CI + 4 * (jq ^ (((v >> 1) & 3) << 1));
}
__host__ __device__ constexpr int gpiece(int ab, int jf, int cq) {
  return (ab * 2 * DW_R + jf) * DW_CO + 4 * (cq ^ (((jf >> 2) & 3) << 1));
}
// the fp64 row of channel c: odd quads of channels in the order 1, 0, 3, 2
__host__ __device__ constexpr int crow(int c) { return c ^ ((c >> 2) & 1); }

// Stores channels i = 0..3 of two voxels' float4s u, v as fp64 pairs (u.i,
// v.i) at d + 8 crow(i) of a quad that is odd when lo = 1.
__device__ __forceinline__ void put_pairs(double* d, float4 u, float4 v,
                                          int lo) {
  double* da = d + 8 * lo;
  double* db = d + 8 - 8 * lo;
  *reinterpret_cast<double2*>(da) = make_double2(u.x, v.x);
  *reinterpret_cast<double2*>(db) = make_double2(u.y, v.y);
  *reinterpret_cast<double2*>(da + 16) = make_double2(u.z, v.z);
  *reinterpret_cast<double2*>(db + 16) = make_double2(u.w, v.w);
}

struct DwArgs {
  const float* x;   // (N, D, H, W, Ci)
  const float* gy;  // (N, 2D, 2H, 2W, Co)
  double* part;     // (splits, 8, Ci, Co)
  int H, W, Ci, Co;
  int nwr;          // steps along w: ceil(W / DW_R)
  int steps;        // the batch's: N * D * H * nwr
  int ntci, tiles;  // ci tiles; (ci, co) tiles
  int splits;
};

// A step's copies into its slot: x's DW_R voxel rows of CI channels from
// ci0, and for each pair ab the fine row's 2 DW_R voxels of DW_CO channels
// from co0, zero past w = W unless the step is FULL
template <int CI, bool FULL>
__device__ __forceinline__ void dw_copies(const DwArgs& a, uint32_t xs,
                                          const float* xb,
                                          const float* const (&gb)[4],
                                          int left, int pt) {
  using C = Dw<CI>;
#pragma unroll
  for (int k = 0; k < (C::XC + DW_PRODUCERS - 1) / DW_PRODUCERS; ++k) {
    const int c = pt + k * DW_PRODUCERS;
    if (C::XC % DW_PRODUCERS == 0 || c < C::XC) {
      const int v = c / C::XQ, jq = c % C::XQ;
      const bool in = FULL || v < left;
      cp16(xs + xpiece<CI>(v, jq) * 4,
           in ? xb + (size_t)v * a.Ci + 4 * jq : a.x, in);
    }
  }
  const uint32_t gs = xs + C::X32 * 4;
#pragma unroll
  for (int k = 0; k < C::GC / DW_PRODUCERS; ++k) {
    const int cq = pt % 8, jf = pt / 8;  // of pair k
    const bool in = FULL || jf < 2 * left;
    cp16(gs + gpiece(k, jf, cq) * 4,
         in ? gb[k] + (size_t)jf * a.Co + 4 * cq : a.gy, in);
  }
}

template <int CI>
__global__ void __launch_bounds__(DW_BLOCK, 1)
    upsample2x_dw_f32(const __grid_constant__ DwArgs a) {
  using C = Dw<CI>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* x64 = reinterpret_cast<double*>(smem);
  double* g64 = x64 + NF * C::X64;
  float* ring = reinterpret_cast<float*>(g64 + NF * C::G64);
  // unit u = split * tiles + co tile * ntci + ci tile; split s sums steps
  // [s * steps / splits, (s + 1) * steps / splits)
  const int split = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const int ci0 = (tile % a.ntci) * CI, co0 = (tile / a.ntci) * DW_CO;
  const int s0 = (int)((long long)split * a.steps / a.splits);
  const int steps = (int)((long long)(split + 1) * a.steps / a.splits) - s0;

  if (threadIdx.x >= MMA_THREADS) {
    reg_dealloc<DW_PROD_REGS>();
    const int pt = threadIdx.x - MMA_THREADS;
    // the step copied next: coarse row (nd, h), nd = n * D + d, and its
    // w range [wr * DW_R, wr * DW_R + DW_R)
    const int row = s0 / a.nwr;
    int wr = s0 - row * a.nwr, nd = row / a.H, h = row - nd * a.H;
    auto issue = [&](int j) {
      const uint32_t xs = smem_u32(ring + (j % NST) * C::SLOT);
      const int w0 = wr * DW_R, left = a.W - w0;
      const float* xb =
          a.x + ((size_t)(nd * a.H + h) * a.W + w0) * a.Ci + ci0;
      // the fine row (2 nd + a, 2 h + b) of pair ab = 2a + b, from 2 w0
      const float* gb[4];
#pragma unroll
      for (int ab = 0; ab < 4; ++ab)
        gb[ab] = a.gy +
                 (((size_t)(2 * nd + (ab >> 1)) * 2 * a.H + 2 * h + (ab & 1)) *
                      2 * a.W + 2 * w0) * a.Co + co0;
      if (left >= DW_R) dw_copies<CI, true>(a, xs, xb, gb, left, pt);
      else dw_copies<CI, false>(a, xs, xb, gb, left, pt);
      if (++wr < a.nwr) return;
      wr = 0;
      if (++h < a.H) return;
      h = 0;
      ++nd;
    };
    // Converts a slot once into the fp64 buffers. x item e: voxels 2vp,
    // 2vp + 1 (vp = 4 ks + q) x ci quad jq; gy item e: fine voxels 4vp ..
    // 4vp + 3 of pair ab (coarse 2vp + u / 2, c = u % 2) x co quad cq; the
    // low bits of e are q, then the quad's low bit lo, so that a
    // quarter-warp's items are 4 q x 2 quads.
    auto convert = [&](const float* slot, double* xf, double* gf) {
#pragma unroll
      for (int k = 0; k < (C::XI + DW_PRODUCERS - 1) / DW_PRODUCERS; ++k) {
        const int e = pt + k * DW_PRODUCERS;
        if (C::XI % DW_PRODUCERS == 0 || e < C::XI) {
          const int q = e & 3, lo = (e >> 2) & 1, rest = e >> 3;
          const int jq = 2 * (rest % (C::XQ / 2)) + lo;
          const int ks = rest / (C::XQ / 2), v = 2 * (4 * ks + q);
          const float4 u0 =
              *reinterpret_cast<const float4*>(slot + xpiece<CI>(v, jq));
          const float4 u1 =
              *reinterpret_cast<const float4*>(slot + xpiece<CI>(v + 1, jq));
          put_pairs(xf + (ks * CI + 4 * jq) * 8 + 2 * q, u0, u1, lo);
        }
      }
      const float* gsl = slot + C::X32;
#pragma unroll
      for (int k = 0; k < C::GI / DW_PRODUCERS; ++k) {
        const int e = pt + k * DW_PRODUCERS;
        const int q = e & 3, lo = (e >> 2) & 1, rest = e >> 3;
        const int cq = 2 * (rest % (DW_CO / 8)) + lo;
        const int ks = rest / (DW_CO / 8) % DW_KS;
        const int ab = rest / (DW_CO / 8 * DW_KS), jf = 4 * (4 * ks + q);
        float4 u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          u[r] = *reinterpret_cast<const float4*>(gsl +
                                                  gpiece(ab, jf + r, cq));
        double* d = gf + ((ks * 8 + 2 * ab) * DW_CO + 4 * cq) * 8 + 2 * q;
        put_pairs(d, u[0], u[2], lo);               // c = 0
        put_pairs(d + DW_CO * 8, u[1], u[3], lo);   // c = 1
      }
    };
#pragma unroll
    for (int j = 0; j < NST - 1; ++j) {
      if (j < steps) issue(j);
      cp_commit();
    }
    for (int j = 0; j < steps; ++j) {
      cp_wait<NST - 2>();                // this thread's copies of step j
      bar_sync(BAR_PROD, DW_PRODUCERS);  // all copies; step j - 1 converted
      if (j + NST - 1 < steps) issue(j + NST - 1);
      cp_commit();
      if (j >= NF) bar_sync(BAR_EMPTY + j % NF, DW_BLOCK);
      convert(ring + (j % NST) * C::SLOT, x64 + (j % NF) * C::X64,
              g64 + (j % NF) * C::G64);
      bar_arrive(BAR_FULL + j % NF, DW_BLOCK);
    }
    return;
  }

  // the MMA warps: warp w takes pair ab = w % 4 (parities 2 ab + c) and
  // the ci half w / 4; lane (g, t) reads the rows of channels g, g + 8 (A)
  // and g (B) at voxels 2t, 2t + 1 of each k-step
  reg_alloc<DW_MMA_REGS>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ab = warp & 3, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int bo = (half * 8 * C::NT + crow(g)) * 8 + 2 * t;
  const int ao = (2 * ab * DW_CO + crow(g)) * 8 + 2 * t;
  double acc[2][2][C::NT][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][mi][ni][e] = 0.0;
  for (int j = 0; j < steps; ++j) {
    bar_sync(BAR_FULL + j % NF, DW_BLOCK);
    const double* xb = x64 + (j % NF) * C::X64 + bo;
    const double* gb = g64 + (j % NF) * C::G64 + ao;
#pragma unroll
    for (int ks = 0; ks < DW_KS; ++ks) {
      double bf[C::NT][2];
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni) {
        const double2 v =
            *reinterpret_cast<const double2*>(xb + (ks * CI + 8 * ni) * 8);
        bf[ni][0] = v.x;
        bf[ni][1] = v.y;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const double* ap = gb + ((ks * 8 + c) * DW_CO + 16 * mi) * 8;
          const double2 lo = *reinterpret_cast<const double2*>(ap);
          const double2 hi = *reinterpret_cast<const double2*>(ap + 64);
          const double af[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
          for (int ni = 0; ni < C::NT; ++ni) dmma(acc[c][mi][ni], af, bf[ni]);
        }
    }
    if (j + NF < steps) bar_arrive(BAR_EMPTY + j % NF, DW_BLOCK);
  }
  // the unit's sums to its split's slice: lane (g, t) holds co 16 mi + g
  // (+ 8) x ci 8 ni + 2t (+ 1) of parity 2 ab + c
  double* out = a.part + (size_t)split * 8 * a.Ci * a.Co;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = ci0 + half * 8 * C::NT + 8 * ni + 2 * t + (e & 1);
          const int co = co0 + 16 * mi + g + 8 * (e >> 1);
          out[((size_t)(2 * ab + c) * a.Ci + ci) * a.Co + co] =
              acc[c][mi][ni][e];
        }
}

// dW[i] = the slices' sums added in split order, rounded once
__global__ void __launch_bounds__(DW_FIN)
    upsample2x_dw_f32_split_finish(const double* __restrict__ part,
                                   float* __restrict__ dw, long long len,
                                   int splits) {
  const long long i = (long long)blockIdx.x * DW_FIN + threadIdx.x;
  if (i >= len) return;
  double s = 0.0;
  for (int k = 0; k < splits; ++k) s += part[k * len + i];
  dw[i] = (float)s;
}

template <int CI>
int dw(const void* x, const void* gy, void* out, void* part, int N, int D,
       int H, int W, int Ci, int Co, int splits, int grid, int smem,
       long long part_len, int fin_grid, cudaStream_t st) {
  using C = Dw<CI>;
  DwArgs a{};
  a.x = static_cast<const float*>(x);
  a.gy = static_cast<const float*>(gy);
  a.part = static_cast<double*>(part);
  a.H = H, a.W = W, a.Ci = Ci, a.Co = Co;
  a.nwr = (W + DW_R - 1) / DW_R;
  const long long steps = (long long)N * D * H * a.nwr;
  a.ntci = Ci / CI;
  a.tiles = a.ntci * (Co / DW_CO);
  const long long len = 8LL * Ci * Co;
  if (steps >= (1ll << 31) || splits < 1 || splits > steps ||
      (long long)grid != (long long)splits * a.tiles ||
      (size_t)smem != C::SMEM || part_len != splits * len ||
      fin_grid != (len + DW_FIN - 1) / DW_FIN)
    return (int)cudaErrorInvalidValue;
  // setmaxnreg can only hand out what the launch allocated
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, upsample2x_dw_f32<CI>);
  if (e != cudaSuccess) return (int)e;
  if (fa.numRegs != DW_REGS) return (int)cudaErrorInvalidConfiguration;
  a.steps = (int)steps;
  a.splits = splits;
  const int rc =
      launch(upsample2x_dw_f32<CI>, dim3(grid), smem, a, st, DW_BLOCK);
  if (rc != 0) return rc;
  upsample2x_dw_f32_split_finish<<<fin_grid, DW_FIN, 0, st>>>(
      a.part, static_cast<float*>(out), len, splits);
  return (int)cudaGetLastError();
}

}  // namespace up32

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

// dwf (2, 2, 2, Ci, Co) fp32 from x (N, D, H, W, Ci) and gy (N, 2D, 2H, 2W,
// Co) (ops/upsample.py _up_f32_dw_plan): ci_tile 64 where Ci % 64 == 0,
// else 32; the batch's steps of 16 coarse voxels split into `splits`
// ranges, one block a unit (grid = splits x the (ci, co) tiles), each
// storing its fp64 sums to its slice of part (part_len = splits x 8 x Ci x
// Co doubles), added and rounded once by a finish of fin_grid blocks of
// 256; smem must be the tile's.
extern "C" int upsample2x_f32_dw_launch(const void* x, const void* gy,
                                        void* dw, void* part, int N, int D,
                                        int H, int W, int Ci, int Co,
                                        int ci_tile, int splits, int grid,
                                        int smem, long long part_len,
                                        int fin_grid, void* stream) {
  if (!up32::shape_ok(N, D, H, W, Ci, Co) || part == nullptr ||
      ci_tile != (Ci % 64 == 0 ? 64 : 32) ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(gy) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ci_tile == 64)
    return up32::dw<64>(x, gy, dw, part, N, D, H, W, Ci, Co, splits, grid,
                        smem, part_len, fin_grid, st);
  return up32::dw<32>(x, gy, dw, part, N, D, H, W, Ci, Co, splits, grid,
                      smem, part_len, fin_grid, st);
}
