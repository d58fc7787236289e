// The weight gradient (dW) of the 3x3x3 pad-1 convolution on NDHWC fp32,
// stride 1 or 2, on the FP64 tensor cores at fp32 accuracy, for Hopper
// (sm_90a). Plain C interface, bound with ctypes (ops/conv3d.py
// conv3d_k3_dw on fp32 tensors). The forward is conv3d_k3_f32_fwd.cu, dx
// conv3d_k3_f32_dx.cu; the bf16 kernels of the same function are
// conv3d_k3_dw_{s1,s2}.cu.
//
// Replaces, at compute dtype float32, the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_dw_kernel (via
//     conv3d_dw_packed)                          -> conv3d_k3_dw_s1_f32
//   ::_s2_dw_kernel (via _conv3d_s2_dw_impl)     -> conv3d_k3_dw_s2_f32
// which the JAX package runs at fp32 with its `sub = 8` tiling. It computes
//   dW[k, ci, co] = sum over the batch's output voxels v of
//                   xin[S*v + k - 1, ci] * g'[v, co]
// with xin zero outside the volume, and the fusions of the bf16 kernels:
//   PRE   xin = leaky(x*scale - shift), applied once per staged element in
//         fp32 as the plain version rounds it; the padding stays zero;
//   CORR  g' = gy + gs[0] + 2 y gs[1], built once per staged element in
//         fp32 as the plain version rounds it; 0 outside the volume.
//
// Products. mma.sync.m16n8k8.f64 on the FP64 tensor cores (wgmma has no
// fp64 form): an fp32 operand converts to fp64 exactly and the product of
// two is exact, the sums round to nearest in fp64, so dW's only error is
// its final rounding to fp32.
//
// What bounds it on the H100: the FP64 tensor cores, 67 TFLOP/s (stride 1
// at 128^3 x 32 -> 32, N = 2: 232 GFLOP, 3.46 ms; stride 2 at 64^3 x 64
// from 128^3 x 32: 58 GFLOP, 0.87 ms). Its first design (register-staged
// 2 x 2-warp tiles over 3 taps of 32 ci) gathered x for every tap group
// and rebuilt the corrected cotangent for every ci tile through registers,
// applying PRE and CORR at each gather, with three integer divisions a
// float4, and converted every operand to fp64 at every fragment read.
//
// Design (conv3d_k3_f32_fwd.cu's, with K the voxels):
//   Units. A unit is all 27 taps of a CO x CI (co, ci) tile x a range of
//     the batch's output bricks (K; all of them unless K is split). The
//     GEMM's M is co, its N ci: the cotangent is the A operand, unshifted,
//     and the input the B operand, read by each tap at its offset in the
//     staged footprint. The 12 MMA warps are (kd, m-tile, n-tile), MT x NT
//     = 4 tiles of 16 x 8 a tap: warp (kd, mi, ni) holds the 9 taps (kd,
//     kh, kw) of its tile (9 MMA tiles, 72 registers of fp64 sums), so an
//     A fragment serves 9 MMAs, and each of the 4 SM quarters runs 3 MMA
//     warps (9 warps, one per (kh, kw) with 3 kd taps of 2 x 2 tiles, would
//     put 3 on one quarter and 2 on the others, capping the FP64 tensor
//     cores at 75%). Tile 0 (stride 1): a 2 x 4 x 8 brick, CO 32 x CI 16;
//     tile 1 (stride 1, output extents <= 4): 4 x 4 x 4; tile 2 (stride 2,
//     Co % 64 == 0): 2 x 2 x 8, CO 64 x CI 8, so that a staged input
//     element serves twice the MMAs (at stride 2 an input voxel serves 27 /
//     8 taps on average, against 27 at stride 1); tile 3 (stride 2, Co % 64
//     != 0): 2 x 2 x 8, CO 32 x CI 16.
//   Steps. A step is one brick: the producers stage its input footprint
//     (stride 1: the halo'd (BD+2) x (BH+2) x (BW+2) rows of CI channels;
//     stride 2: the (2BD+1) x (2BH+1) x (2BW+1) footprint by parity class,
//     as conv3d_k3_f32_fwd.cu stages it: along an axis the even inputs
//     2(o0 + r), BD rows, taken by tap 1, the odd ones 2(o0 + r) - 1, BD +
//     1 rows, taken by taps 0 and 2 at row offsets 0 and 1, so that a tap's
//     consecutive output w are consecutive rows) and its cotangent rows
//     (BD x BH x BW of CO channels; y's beside them under CORR). A step's
//     MMAs: 8 output voxels (one MMA k) at a time, the A fragment of their
//     cotangent rows once, then each of the 9 taps' B fragments at its rows.
//   Warps. A block is the 12 MMA warps and 4 producer warps, one block an
//     SM, persistent over its range of units. The producers issue the
//     cp.async copies of the fp32 rows (16 bytes, zero-filled outside the
//     volume) NST - 1 steps ahead into NST fp32 slots, with PRE's [scale;
//     shift] and CORR's [gs0; gs1] of the tile's channels beside them, and
//     convert each step once into one of two fp64 buffers while the MMA
//     warps multiply the other; named barriers hand the buffers over
//     ("full": converted, "empty": multiplied). The ring flows across unit
//     boundaries, so one unit's epilogue overlaps the next unit's copies
//     and conversion. A producer shares its SM quarter's issue slots with
//     3 MMA warps, so its work per step is kept short: each thread's
//     16-byte items (a row's quarter of channels) keep their geometry in
//     registers for the whole launch (Items: the fp64 position, the voxel
//     offset, the packed offset for the volume test), a brick whose
//     footprint lies inside the volume skips the test, and a copy's inside
//     bit goes to shared memory for its conversion.
//   Convert once. Under PRE the input rows get leaky(x*scale - shift)
//     where the voxel is inside the volume and 0 elsewhere; under CORR the
//     cotangent rows g' = (gy + gs0) + 2 y gs1 inside and 0 elsewhere.
//     Converted elements are stored as 16-byte pairs of doubles whose
//     position in the row is XOR-swizzled by the row's low bits (swz), so
//     that a quarter-warp's 16-byte cotangent loads (lane (g, t): rows t
//     and t + 4, the pair at 2 MT g + 2 mi) hit the 8 bank groups once and
//     a half-warp's 8-byte input loads (rows t and t + 4, double g + 8 ni)
//     16 distinct words. The input's rows along w are padded to a multiple
//     of 4 in the fp64 buffers (the padding is never read), so a tap's rows
//     move by multiples of 4 from one MMA k to the next and every fragment
//     load is a base register of the lane plus a constant. The MMA rows of
//     m-tile mi map to co = 2 MT g + 2 mi + h (row g + 8h), so a lane's two
//     A values of a voxel are one pair; column n of n-tile ni is ci 8 ni +
//     n.
//   Epilogue. A unit's sums, rounded to fp32, go to dW (unsplit), or in
//     fp64 to its split's slice of a (splits, 27, Ci, Co) scratch, which
//     conv3d_k3_dw_s{1,2}_f32_split_finish adds in split order and rounds
//     once.
//   L2. Units are numbered with the ci tile fastest, then the co tile,
//     then the split (ops/conv3d.py f32_dw_unit), so the tiles of one brick
//     range run side by side on neighbouring blocks, and a brick's input
//     and cotangent, read by each of them, come from HBM once.
//   Determinism. No atomics: two runs give bit-equal dW.
//
// Requirements (checked by the wrapper and here; the wrapper copies a
// misaligned pre or gs): Ci % 32 == 0, Co % 32 == 0, contiguous 16-byte
// aligned x, gy, y, pre and gs; extents up to 1023; the launch's plan
// (tile, splits, grid, dynamic shared memory, scratch length, finish grid)
// the planner's (ops/conv3d.py _f32_dw_plan).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MMA_WARPS = 12;           // (kd, m-tile, n-tile): 3 per SM quarter
constexpr int THREADS = 32 * MMA_WARPS;
constexpr int PRODUCERS = 128;          // the 4 warps that copy and convert
constexpr int BLOCK = THREADS + PRODUCERS;
// named barriers (0 is __syncthreads): the two fp64 buffers' "full" and
// "empty" (the MMA warps and the producers), the producers alone
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5;
constexpr int NF = 2;                   // fp64 buffers: one multiplied, one filled
constexpr int FIN_THREADS = 256;        // threads a block of the split finish

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

struct Args {
  const float* x;       // (N, D, H, W, Ci)
  const float* gy;      // (N, Do, Ho, Wo, Co)
  const float* pre;     // PRE: (N, 2, Ci), or null
  const float* y;       // CORR: the forward's output (as gy), or null
  const float* gs;      // CORR: (N, 2, Co)
  float* dw;            // unsplit: (27, Ci, Co)
  double* part;         // split: (splits, 27, Ci, Co)
  int N, D, H, W, Ci, Co;   // x's extent
  int Do, Ho, Wo;           // the cotangent's
  int nbh, nbw, NB;     // output bricks per axis (h, w) and per sample
  int ntci, ntiles;     // ci tiles; (ci, co) tiles
  int bricks, splits;   // the batch's bricks (N * NB), K's splits
  int units;
  float slope;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The tile of a unit: output brick BD x BH x BW (KSTEPS MMA k of 8 voxels),
// CO x CI channels, NST fp32 slots.
template <int S_, int BD_, int BH_, int BW_, int CO_, int CI_, int NST_>
struct Cfg {
  static constexpr int S = S_, BD = BD_, BH = BH_, BW = BW_;
  static constexpr int CO = CO_, CI = CI_, NST = NST_;
  static constexpr int V = BD * BH * BW;
  static constexpr int KSTEPS = V / 8;
  static constexpr int MT = CO / 16, NT = CI / 8;
  // the staged input regions: stride 1 the halo'd brick, stride 2 the 8
  // parity classes (c = 4 p_d + 2 p_h + p_w, odd axes p = 1) of the
  // footprint, one after another; in the fp64 buffers each region's rows
  // along w are padded to a multiple of 4 (the padding is never read), so
  // that every tap's row offset from a k-step to the next is a multiple of
  // 4
  static constexpr int REGIONS = S == 1 ? 1 : 8;
  __host__ __device__ static constexpr int ext(int r, int ax) {
    return S == 1 ? (ax == 0 ? BD : ax == 1 ? BH : BW) + 2
                  : (ax == 0 ? BD : ax == 1 ? BH : BW) + ((r >> (2 - ax)) & 1);
  }
  __host__ __device__ static constexpr int rows(int r) {
    return ext(r, 0) * ext(r, 1) * ext(r, 2);
  }
  __host__ __device__ static constexpr int padded(int r) {
    return ext(r, 0) * ext(r, 1) * round4(ext(r, 2));
  }
  __host__ __device__ static constexpr int base(int r) {  // in the fp64 rows
    int b = 0;
    for (int i = 0; i < r; ++i) b += padded(i);
    return b;
  }
  __host__ __device__ static constexpr int real_rows() {
    int b = 0;
    for (int i = 0; i < REGIONS; ++i) b += rows(i);
    return b;
  }
};

template <class C>
struct Geo {
  static constexpr int XROWS = C::real_rows();    // staged input rows
  static constexpr int XPAD = C::base(C::REGIONS);  // their padded rows
  static constexpr int XF = XPAD * C::CI;     // doubles of an fp64 input brick
  static constexpr int XR = XROWS * C::CI;    // floats of its fp32 slot
  static constexpr int GF = C::V * C::CO;     // cotangent (y) floats, doubles
  static constexpr int PAR = 2 * C::CI + 2 * C::CO;  // PRE's and CORR's sums
  // a producer thread's 16-byte items: the input's, the cotangent's
  static constexpr int QX = C::CI / 4, QG = C::CO / 4;
  static constexpr int IX = (XROWS * QX + PRODUCERS - 1) / PRODUCERS;
  static constexpr int IG = (C::V * QG + PRODUCERS - 1) / PRODUCERS;
  // shared memory, in this order: NF fp64 input bricks, NF fp64 cotangent
  // bricks, NST fp32 slots (input, cotangent, PRE's scale and shift and
  // CORR's gs), a word of inside bits a producer thread and slot, and
  // under CORR NST fp32 slots of y
  static constexpr int SLOT = XR + GF + PAR;  // floats
  static constexpr size_t SMEM = (size_t)NF * (XF + GF) * 8 +
                                 (size_t)C::NST * SLOT * 4 +
                                 (size_t)C::NST * PRODUCERS * 4;
  static constexpr size_t SMEM_Y = (size_t)C::NST * GF * 4;
  static constexpr size_t smem(bool corr) { return SMEM + (corr ? SMEM_Y : 0); }
  static_assert(C::MT * C::NT * 3 == MMA_WARPS,
                "a warp per (kd, m-tile, n-tile)");
  static_assert(C::V % 8 == 0 && C::BW % 4 == 0,
                "an MMA k's voxels t = 0..3 are consecutive rows");
  static_assert(C::NST >= 2, "a copy runs ahead of the conversion");
  static_assert(PRODUCERS % QX == 0 && PRODUCERS % QG == 0,
                "a producer's items are the same channels");
  static_assert(IX + IG <= 32, "one inside bit an item");
  static_assert(PAR / 4 <= PRODUCERS, "one 16-byte copy a thread");
  static_assert(SMEM + SMEM_Y <= 232448, "227 KB of shared memory");
};

// The physical position of logical double `pos` of staged row `row` in a
// buffer of RW-double rows: 16-byte pairs XOR-swizzled by the row's low
// two bits, so that the 4 consecutive rows a quarter-warp's fragment loads
// read (lane g at pos g * RW / 8) spread over the 8 bank groups (RW = 8 or
// 16: the 16 lanes of a half-warp's 8-byte loads at pos g + 8 ni over 16
// words). swz(row + 4k, pos) = swz(row, pos) + 4k RW.
template <int RW>
__host__ __device__ __forceinline__ int swz(int row, int pos) {
  static_assert(RW == 8 || RW == 16 || RW == 32 || RW == 64, "row width");
  const int m = RW == 8    ? ((row >> 1) & 1) << 1
                : RW == 16 ? (row & 3) << 1
                : RW == 32 ? (row & 1) | ((row & 2) << 1)
                           : row & 3;
  return row * RW + (pos ^ (m << 1));
}

struct Unit {
  int split, cit, cot;  // K's split, ci and co tile
  int b0, b1;           // its bricks [b0, b1) of the batch's
};

// unit u = (split * ntco + cot) * ntci + cit (ops/conv3d.py f32_dw_unit);
// split s takes bricks [s * bricks / splits, (s + 1) * bricks / splits)
__device__ __forceinline__ Unit decode(const Args& a, int u) {
  Unit t;
  const int tile = u % a.ntiles;
  t.split = u / a.ntiles;
  t.cit = tile % a.ntci;
  t.cot = tile / a.ntci;
  t.b0 = (int)((long long)t.split * a.bricks / a.splits);
  t.b1 = (int)((long long)(t.split + 1) * a.bricks / a.splits);
  return t;
}

// A brick b of the batch: sample n = b / NB, output origin (d0, h0, w0)
struct Brick {
  int n, d0, h0, w0;
};

template <class C>
__device__ __forceinline__ Brick brick_of(const Args& a, int b) {
  Brick k;
  k.n = b / a.NB;
  int r = b - k.n * a.NB;
  k.w0 = (r % a.nbw) * C::BW;
  r /= a.nbw;
  k.h0 = (r % a.nbh) * C::BH;
  k.d0 = (r / a.nbh) * C::BD;
  return k;
}

// A walk over a block's steps: unit u and its brick b, advanced one step
// at a time, the unit decoded only when it changes.
struct Cursor {
  int u, b;
  Unit t;
  __device__ Cursor(const Args& a, int u0) : u(u0) {
    t = decode(a, u);
    b = t.b0;
  }
  __device__ bool last() const { return b == t.b1 - 1; }
  __device__ void next(const Args& a) {
    if (++b < t.b1) return;
    t = decode(a, ++u);
    b = t.b0;
  }
};

// the index of a producer thread (threads THREADS .. BLOCK - 1)
__device__ __forceinline__ int ptid() { return threadIdx.x - THREADS; }

__device__ __forceinline__ int pack(int d, int h, int w) {
  return (d + 1) | (h + 1) << 10 | (w + 1) << 20;
}

// is voxel (o0 + the packed offset) inside an extent (D, H, W)?
__device__ __forceinline__ bool inside(int pk, int d0, int h0, int w0, int D,
                                       int H, int W) {
  return (unsigned)(d0 + (pk & 1023) - 1) < (unsigned)D &&
         (unsigned)(h0 + ((pk >> 10) & 1023) - 1) < (unsigned)H &&
         (unsigned)(w0 + (pk >> 20) - 1) < (unsigned)W;
}

// A producer thread's items, fixed over the launch. Input item i is
// 16-byte quarter QX's ptid % QX of staged row e / QX, e = ptid + i *
// PRODUCERS, counting the regions' rows one after another: its fp64 pair
// position (swizzled), its input voxel's offset from (S d0, S h0, S w0) in
// the volume and packed. Cotangent item i is quarter ptid % QG of brick
// voxel e / QG: its offset from (d0, h0, w0) in the output volume, packed.
template <class C>
struct Items {
  using G = Geo<C>;
  int xdst[G::IX], xrel[G::IX], xpk[G::IX];
  int grel[G::IG], gpk[G::IG];
  __device__ Items(const Args& a) {
#pragma unroll
    for (int i = 0; i < G::IX; ++i) {
      const int e = ptid() + i * PRODUCERS, q = e % G::QX;
      int r = e / G::QX, reg = 0;
      while (reg < C::REGIONS - 1 && r >= C::rows(reg)) r -= C::rows(reg++);
      const int ew = C::ext(reg, 2), eh = C::ext(reg, 1);
      const int rw = r % ew, rh = r / ew % eh, rd = r / (ew * eh);
      // stride 1: input o0 - 1 + r; stride 2: 2 (o0 + r) - p
      const int od = C::S * rd - (C::S == 1 ? 1 : (reg >> 2) & 1);
      const int oh = C::S * rh - (C::S == 1 ? 1 : (reg >> 1) & 1);
      const int ow = C::S * rw - (C::S == 1 ? 1 : reg & 1);
      const int row = C::base(reg) + (rd * eh + rh) * round4(ew) + rw;
      const bool real = e < G::XROWS * G::QX;
      xdst[i] = real ? swz<C::CI>(row, 4 * q) : -1;
      xrel[i] = (od * a.H + oh) * a.W + ow;
      xpk[i] = pack(od, oh, ow);
    }
#pragma unroll
    for (int i = 0; i < G::IG; ++i) {
      const int v = (ptid() + i * PRODUCERS) / G::QG;
      const int ow = v % C::BW, oh = v / C::BW % C::BH,
                od = v / (C::BW * C::BH);
      grel[i] = (od * a.Ho + oh) * a.Wo + ow;
      gpk[i] = pack(od, oh, ow);
    }
  }
};

// The copies of a step into its fp32 slot: the input items (CI channels
// from ci0, zero-filled outside the volume) and the cotangent's (CO from
// co0; y's beside them under CORR), PRE's scale and shift of the tile's
// channels and CORR's gs. Returns the items' inside bits (input items
// first).
template <class C>
__device__ __forceinline__ uint32_t issue(const Args& a, const Items<C>& it,
                                          const Unit& t, int b, float* slot,
                                          float* yslot) {
  using G = Geo<C>;
  const Brick k = brick_of<C>(a, b);
  const int ci0 = t.cit * C::CI, co0 = t.cot * C::CO;
  const uint32_t xs = smem_u32(slot), gs = xs + G::XR * 4,
                 ps = gs + G::GF * 4, ys = smem_u32(yslot);
  const int sd = C::S * k.d0, sh = C::S * k.h0, sw = C::S * k.w0;
  // the footprint inside the volume: input o0 - 1 .. S o0 + (S == 1 ? B :
  // 2B - 1) along each axis; the brick inside the output volume
  const bool xall = sd >= 1 && sh >= 1 && sw >= 1 &&
                    sd + (C::S == 1 ? C::BD : 2 * C::BD - 1) < a.D &&
                    sh + (C::S == 1 ? C::BH : 2 * C::BH - 1) < a.H &&
                    sw + (C::S == 1 ? C::BW : 2 * C::BW - 1) < a.W;
  const bool gall = k.d0 + C::BD <= a.Do && k.h0 + C::BH <= a.Ho &&
                    k.w0 + C::BW <= a.Wo;
  const float* xb = a.x +
                    ((((long long)k.n * a.D + sd) * a.H + sh) * a.W + sw) *
                        a.Ci +
                    ci0 + 4 * (ptid() % G::QX);
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < G::IX; ++i) {
    const int e = ptid() + i * PRODUCERS;
    if ((G::XROWS * G::QX) % PRODUCERS == 0 || e < G::XROWS * G::QX) {
      const bool in =
          xall || inside(it.xpk[i], sd, sh, sw, a.D, a.H, a.W);
      cp16(xs + e * 16, in ? xb + (long long)it.xrel[i] * a.Ci : a.x, in);
      bits |= (uint32_t)in << i;
    }
  }
  const long long gb =
      (((long long)k.n * a.Do + k.d0) * a.Ho + k.h0) * a.Wo + k.w0;
  const int gq = co0 + 4 * (ptid() % G::QG);
#pragma unroll
  for (int i = 0; i < G::IG; ++i) {
    const int e = ptid() + i * PRODUCERS;
    if ((C::V * G::QG) % PRODUCERS == 0 || e < C::V * G::QG) {
      const bool in =
          gall || inside(it.gpk[i], k.d0, k.h0, k.w0, a.Do, a.Ho, a.Wo);
      const long long o = in ? (gb + it.grel[i]) * a.Co + gq : 0;
      cp16(gs + e * 16, a.gy + o, in);
      if (a.y) cp16(ys + e * 16, a.y + o, in);
      bits |= (uint32_t)in << (G::IX + i);
    }
  }
  // PRE's [scale; shift] of channels ci0.., CORR's [gs0; gs1] of co0..
  const int p = ptid();
  if (a.pre && p < C::CI / 2) {
    const int j = p / (C::CI / 4), c = 4 * (p % (C::CI / 4));
    cp16(ps + (j * C::CI + c) * 4,
         a.pre + ((long long)k.n * 2 + j) * a.Ci + ci0 + c, true);
  }
  if (a.y && p < C::CO / 2) {
    const int j = p / (C::CO / 4), c = 4 * (p % (C::CO / 4));
    cp16(ps + (2 * C::CI + j * C::CO + c) * 4,
         a.gs + ((long long)k.n * 2 + j) * a.Co + co0 + c, true);
  }
  return bits;
}

__device__ __forceinline__ float leaky(float u, float slope) {
  return u >= 0.f ? u : __fmul_rn(u, slope);
}

// PRE on one value: leaky(x * scale - shift), rounded as the plain version
// rounds it, 0 outside the volume
__device__ __forceinline__ float pre1(float x, float sc, float sh, bool in,
                                      float slope) {
  return in ? leaky(__fsub_rn(__fmul_rn(x, sc), sh), slope) : 0.f;
}

// CORR on one value: (gy + gs0) + 2 y gs1, 0 outside the volume
__device__ __forceinline__ float corr1(float g, float y, float g0, float g1,
                                       bool in) {
  return in ? __fadd_rn(__fadd_rn(g, g0), __fmul_rn(__fmul_rn(2.f, y), g1))
            : 0.f;
}

// stores 4 converted values at pair positions p and p ^ 2 of an fp64 row
__device__ __forceinline__ void put4(double* f, int p, float4 v) {
  *reinterpret_cast<double2*>(f + p) = make_double2(v.x, v.y);
  *reinterpret_cast<double2*>(f + (p ^ 2)) = make_double2(v.z, v.w);
}

// Converts a step's fp32 slot once into the fp64 input and cotangent
// bricks that the MMAs read: PRE's leaky(x*scale - shift) inside the
// volume and 0 outside, CORR's g' = (gy + gs0) + 2 y gs1 inside and 0
// outside, each rounded in fp32 as the plain version rounds it.
template <class C>
__device__ __forceinline__ void convert(const Args& a, const Items<C>& it,
                                        uint32_t bits, const float* slot,
                                        const float* yslot, double* xf,
                                        double* gf) {
  using G = Geo<C>;
  const float* par = slot + G::XR + G::GF;
  const int cx = 4 * (ptid() % G::QX), cg = 4 * (ptid() % G::QG);
  const float4 sc = *reinterpret_cast<const float4*>(par + cx);
  const float4 sf = *reinterpret_cast<const float4*>(par + C::CI + cx);
  const float4 g0 = *reinterpret_cast<const float4*>(par + 2 * C::CI + cg);
  const float4 g1 =
      *reinterpret_cast<const float4*>(par + 2 * C::CI + C::CO + cg);
#pragma unroll
  for (int i = 0; i < G::IX; ++i) {
    const int e = ptid() + i * PRODUCERS;
    if ((G::XROWS * G::QX) % PRODUCERS == 0 || e < G::XROWS * G::QX) {
      float4 v = reinterpret_cast<const float4*>(slot)[e];
      if (a.pre) {
        const bool in = (bits >> i) & 1;
        v.x = pre1(v.x, sc.x, sf.x, in, a.slope);
        v.y = pre1(v.y, sc.y, sf.y, in, a.slope);
        v.z = pre1(v.z, sc.z, sf.z, in, a.slope);
        v.w = pre1(v.w, sc.w, sf.w, in, a.slope);
      }
      put4(xf, it.xdst[i], v);
    }
  }
  const float* graw = slot + G::XR;
#pragma unroll
  for (int i = 0; i < G::IG; ++i) {
    const int e = ptid() + i * PRODUCERS;
    if ((C::V * G::QG) % PRODUCERS == 0 || e < C::V * G::QG) {
      float4 u = reinterpret_cast<const float4*>(graw)[e];
      if (a.y) {
        const float4 w = reinterpret_cast<const float4*>(yslot)[e];
        const bool in = (bits >> (G::IX + i)) & 1;
        u.x = corr1(u.x, w.x, g0.x, g1.x, in);
        u.y = corr1(u.y, w.y, g0.y, g1.y, in);
        u.z = corr1(u.z, w.z, g0.z, g1.z, in);
        u.w = corr1(u.w, w.w, g0.w, g1.w, in);
      }
      // brick voxel e / QG is its row; row & 3 is the same for every item
      put4(gf, swz<C::CO>(e / G::QG, cg), u);
    }
  }
}

__device__ __forceinline__ void zero(double (&acc)[9][4]) {
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0;
}

// Tap i = (kh, kw) = (i / 3, i % 3) of kd, in its staged region: the
// region's extent along h and its padded row length along w, and the row
// read by brick voxel (0, 0, 0): stride 1 the halo'd brick at (kd, kh,
// kw); stride 2 parity class (kd != 1, kh != 1, kw != 1) at (kd == 2, kh
// == 2, kw == 2). Brick voxel (od, oh, ow) reads row0 + (od * SH + oh) *
// SW + ow.
template <class C>
__host__ __device__ constexpr int tap_region(int kd, int i) {
  return C::S == 1 ? 0
                   : 4 * (kd != 1) + 2 * (i / 3 != 1) + (i % 3 != 1);
}
template <class C>
__host__ __device__ constexpr int tap_sh(int i) {
  return C::ext(tap_region<C>(0, i), 1);
}
template <class C>
__host__ __device__ constexpr int tap_sw(int i) {
  return round4(C::ext(tap_region<C>(0, i), 2));
}
template <class C>
__host__ __device__ constexpr int tap_row0(int kd, int i) {
  const int kh = i / 3, kw = i % 3;
  const int sh = tap_sh<C>(i), sw = tap_sw<C>(i);
  return C::S == 1 ? (kd * sh + kh) * sw + kw
                   : C::base(tap_region<C>(kd, i)) +
                         ((kd == 2) * sh + (kh == 2)) * sw + (kw == 2);
}

// acc += a step, warp (kd, mi, ni)'s part: for each MMA k of 8 brick
// voxels (k-step s: voxels 8s + t and 8s + 4 + t for lane (g, t)), the
// cotangent's A fragment of m-tile mi once (co = 2 MT g + 2 mi + h, a
// 16-byte pair), then the input B fragment of n-tile ni (ci = 8 ni + g)
// at each of the 9 taps' rows, and 9 MMAs. xa[i], ga: this lane's
// positions at brick voxel t (a k-step's rows are 4k further, so the
// swizzle is the same and every other offset a constant).
template <class C>
__device__ __forceinline__ void mma_step(double (&acc)[9][4],
                                         const double* xs, const double* gs,
                                         const int (&xa)[9], int ga) {
#pragma unroll
  for (int s = 0; s < C::KSTEPS; ++s) {
    double af[4];
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const double2 v = *reinterpret_cast<const double2*>(
          gs + ga + (8 * s + 4 * hv) * C::CO);
      af[2 * hv] = v.x;
      af[2 * hv + 1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      double bf[2];
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        // brick voxel 8s + 4hv + t = (od, oh, ow0 + t)
        constexpr int BHW = C::BH * C::BW;
        const int v0 = 8 * s + 4 * hv;
        const int off = ((v0 / BHW) * tap_sh<C>(i) + (v0 / C::BW) % C::BH) *
                            tap_sw<C>(i) +
                        v0 % C::BW;
        bf[hv] = xs[xa[i] + off * C::CI];
      }
      dmma(acc[i], af, bf);
    }
  }
}

// The unit's epilogue, warp (kd, mi, ni)'s 9 taps: lane (g, t) holds ci =
// 8 ni + 2t + e1 and co = 2 MT g + 2 mi + h, rounded to fp32 into dW
// (unsplit), or in fp64 to the split's slice, a pair (h = 0, 1) a store.
template <class C>
__device__ __forceinline__ void epilogue(const Args& a, const Unit& t,
                                         const double (&acc)[9][4], int kd,
                                         int mi, int ni, int g, int tq) {
  const int co = t.cot * C::CO + 2 * C::MT * g + 2 * mi;
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int ci = t.cit * C::CI + 8 * ni + 2 * tq + e1;
      const long long o = ((long long)(9 * kd + i) * a.Ci + ci) * a.Co + co;
      if (a.part)
        *reinterpret_cast<double2*>(
            a.part + (long long)t.split * 27 * a.Ci * a.Co + o) =
            make_double2(acc[i][e1], acc[i][e1 + 2]);
      else
        *reinterpret_cast<float2*>(a.dw + o) =
            make_float2((float)acc[i][e1], (float)acc[i][e1 + 2]);
    }
}

template <class C>
__device__ __forceinline__ void dw_body(const Args& a) {
  using G = Geo<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* xf = reinterpret_cast<double*>(smem);
  double* gf = xf + NF * G::XF;
  float* ring = reinterpret_cast<float*>(gf + NF * G::GF);
  uint32_t* bits = reinterpret_cast<uint32_t*>(ring + C::NST * G::SLOT);
  float* yring = reinterpret_cast<float*>(bits + C::NST * PRODUCERS);
  const int u0 = (int)((long long)blockIdx.x * a.units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * a.units / gridDim.x);
  int steps = 0;
  for (int u = u0; u < u1; ++u) {
    const Unit t = decode(a, u);
    steps += t.b1 - t.b0;
  }
  if (steps <= 0) return;

  if (threadIdx.x >= THREADS) {
    // the producers: copy step j + NST - 1 while converting step j, each
    // fp64 buffer once the MMA warps are done with its step before
    const Items<C> it(a);
    Cursor cs(a, u0);  // the step copied
    auto stage = [&](int j) {
      const int sl = j % C::NST;
      bits[sl * PRODUCERS + ptid()] = issue<C>(
          a, it, cs.t, cs.b, ring + sl * G::SLOT, yring + sl * G::GF);
      cs.next(a);
    };
#pragma unroll
    for (int j = 0; j < C::NST - 1; ++j) {
      if (j < steps) stage(j);
      cp_commit();
    }
    for (int j = 0; j < steps; ++j) {
      const int sl = j % C::NST;
      cp_wait<C::NST - 2>();          // this thread's copies of step j
      bar_sync(BAR_PROD, PRODUCERS);  // everyone's; step j - 1 converted
      const uint32_t b = bits[sl * PRODUCERS + ptid()];
      if (j + C::NST - 1 < steps) stage(j + C::NST - 1);
      cp_commit();
      if (j >= NF) bar_sync(BAR_EMPTY + j % NF, BLOCK);
      convert<C>(a, it, b, ring + sl * G::SLOT, yring + sl * G::GF,
                 xf + (j % NF) * G::XF, gf + (j % NF) * G::GF);
      bar_arrive(BAR_FULL + j % NF, BLOCK);
    }
    return;
  }

  // the MMA warps: warp w takes kd = w / 4 and the (m, n) tile (mi, ni) =
  // (w % 4 / NT, w % NT) of its 9 taps
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kd = w / 4, mi = w % 4 / C::NT, ni = w % C::NT;
  int xa[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    xa[i] = swz<C::CI>(tap_row0<C>(kd, i) + tq, g + 8 * ni);
  const int ga = swz<C::CO>(tq, 2 * C::MT * g + 2 * mi);
  double acc[9][4];
  zero(acc);
  Cursor cm(a, u0);
  for (int j = 0; j < steps; ++j, cm.next(a)) {
    bar_sync(BAR_FULL + j % NF, BLOCK);
    mma_step<C>(acc, xf + (j % NF) * G::XF, gf + (j % NF) * G::GF, xa, ga);
    if (j + NF < steps) bar_arrive(BAR_EMPTY + j % NF, BLOCK);
    if (cm.last()) {
      epilogue<C>(a, cm.t, acc, kd, mi, ni, g, tq);
      zero(acc);
    }
  }
}

// split K: dW[i] = the slices' sums added in split order, rounded once
__device__ __forceinline__ void split_finish(const double* __restrict__ part,
                                             float* __restrict__ dw,
                                             long long len, int splits) {
  const long long i = (long long)blockIdx.x * FIN_THREADS + threadIdx.x;
  if (i >= len) return;
  double s = 0.0;
  for (int k = 0; k < splits; ++k) s += part[k * len + i];
  dw[i] = (float)s;
}

// the entries, named as the wrappers count their launches (the finishes
// after their stride's, so that a profile puts them in its row)
template <class C>
__global__ void __launch_bounds__(BLOCK, 1)
    conv3d_k3_dw_s1_f32(const __grid_constant__ Args a) {
  dw_body<C>(a);
}
template <class C>
__global__ void __launch_bounds__(BLOCK, 1)
    conv3d_k3_dw_s2_f32(const __grid_constant__ Args a) {
  dw_body<C>(a);
}
__global__ void __launch_bounds__(FIN_THREADS)
    conv3d_k3_dw_s1_f32_split_finish(const double* part, float* dw,
                                     long long len, int splits) {
  split_finish(part, dw, len, splits);
}
__global__ void __launch_bounds__(FIN_THREADS)
    conv3d_k3_dw_s2_f32_split_finish(const double* part, float* dw,
                                     long long len, int splits) {
  split_finish(part, dw, len, splits);
}

// the tiles (ops/conv3d.py F32_DW_TILES)
using S1Big = Cfg<1, 2, 4, 8, 32, 16, 3>;
using S1Small = Cfg<1, 4, 4, 4, 32, 16, 3>;
using S2Wide = Cfg<2, 2, 2, 8, 64, 8, 3>;
using S2Narrow = Cfg<2, 2, 2, 8, 32, 16, 2>;

template <class K>
int launch(K kernel, const Args& a, int grid, int smem, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, BLOCK, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// the tile's bricks and channel tiles; false if the channels do not tile
template <class C>
bool geometry(Args* a, bool corr, size_t* smem) {
  if (a->Ci % C::CI || a->Co % C::CO) return false;
  a->nbh = (a->Ho + C::BH - 1) / C::BH;
  a->nbw = (a->Wo + C::BW - 1) / C::BW;
  a->NB = (a->Do + C::BD - 1) / C::BD * a->nbh * a->nbw;
  a->ntci = a->Ci / C::CI;
  a->ntiles = a->ntci * (a->Co / C::CO);
  *smem = Geo<C>::smem(corr);
  return true;
}

}  // namespace

// dW (3, 3, 3, Ci, Co) fp32 = sum over the batch's output voxels of the
// (pre-op'd, zero-padded) input x (N, D, H, W, Ci) under each tap times the
// (corrected) cotangent gy (N, Do, Ho, Wo, Co), at `stride`, with PRE (pre)
// and CORR (y, gs). tile: 0 stride 1, 1 stride 1 small, 2 stride 2 (Co %
// 64 == 0), 3 stride 2. splits: of the batch's output bricks, at most
// their count; above 1, part is an fp64 scratch of part_len = splits x 27
// x Ci x Co doubles, added by a finish of fin_grid blocks of FIN_THREADS.
// grid: persistent blocks (<= units). smem: the block's dynamic shared
// memory, which must be the tile's in this mode.
extern "C" int conv3d_k3_f32_dw_launch(const void* x, const void* gy,
                                       const void* pre, const void* y,
                                       const void* gs, void* dw, void* part,
                                       int N, int D, int H, int W, int Ci,
                                       int Co, int stride, int tile,
                                       int splits, int grid, int smem,
                                       long long part_len, int fin_grid,
                                       float slope, void* stream) {
  if ((stride != 1 && stride != 2) || tile < 0 || tile > 3 ||
      (tile >= 2) != (stride == 2) || Ci < 32 || Ci % 32 || Co < 32 ||
      Co % 32 || N < 1 || D < 1 || H < 1 || W < 1 || D > 1023 || H > 1023 ||
      W > 1023 || splits < 1 || (y == nullptr) != (gs == nullptr) ||
      (splits > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  // every operand is copied in 16-byte pieces
  const void* const operands[] = {x, gy, pre, y, gs};
  for (const void* p : operands)
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.gy = static_cast<const float*>(gy);
  a.pre = static_cast<const float*>(pre);
  a.y = static_cast<const float*>(y);
  a.gs = static_cast<const float*>(gs);
  a.dw = static_cast<float*>(dw);
  a.part = static_cast<double*>(part);
  a.N = N, a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co;
  a.Do = (D - 1) / stride + 1;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.slope = slope;
  const bool corr = y != nullptr;
  size_t want = 0;
  bool ok;
  if (tile == 0) ok = geometry<S1Big>(&a, corr, &want);
  else if (tile == 1) ok = geometry<S1Small>(&a, corr, &want);
  else if (tile == 2) ok = geometry<S2Wide>(&a, corr, &want);
  else ok = geometry<S2Narrow>(&a, corr, &want);
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long bricks = (long long)N * a.NB;
  const long long units = (long long)splits * a.ntiles;
  const long long len = 27LL * Ci * Co;
  if (bricks >= (1ll << 31) || splits > bricks || units >= (1ll << 31) ||
      grid < 1 || grid > units || (size_t)smem != want ||
      part_len != (splits > 1 ? splits * len : 0) ||
      fin_grid != (splits > 1 ? (len + FIN_THREADS - 1) / FIN_THREADS : 0))
    return (int)cudaErrorInvalidValue;
  a.bricks = (int)bricks;
  a.splits = splits;
  a.units = (int)units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (tile == 0) rc = launch(conv3d_k3_dw_s1_f32<S1Big>, a, grid, smem, st);
  else if (tile == 1)
    rc = launch(conv3d_k3_dw_s1_f32<S1Small>, a, grid, smem, st);
  else if (tile == 2)
    rc = launch(conv3d_k3_dw_s2_f32<S2Wide>, a, grid, smem, st);
  else rc = launch(conv3d_k3_dw_s2_f32<S2Narrow>, a, grid, smem, st);
  if (rc != 0 || splits == 1) return rc;
  double* ps = static_cast<double*>(part);
  float* out = static_cast<float*>(dw);
  if (stride == 1)
    conv3d_k3_dw_s1_f32_split_finish<<<fin_grid, FIN_THREADS, 0, st>>>(
        ps, out, len, splits);
  else
    conv3d_k3_dw_s2_f32_split_finish<<<fin_grid, FIN_THREADS, 0, st>>>(
        ps, out, len, splits);
  return (int)cudaGetLastError();
}
