// The input gradient (dx) of the 3x3x3 pad-1 convolution on NDHWC fp32,
// stride 1 or 2, on the FP64 tensor cores at fp32 accuracy, for Hopper
// (sm_90a). Plain C interface, bound with ctypes (ops/conv3d.py
// conv3d_k3_dx on fp32 tensors). The forward is conv3d_k3_f32_fwd.cu, dW
// conv3d_k3_f32_dw.cu.
//
// Replaces, at compute dtype float32, the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_conv_kernel in its corr/post
//     mode (via _conv3d_dx_fused_f)             -> conv3d_k3_dx_s1_f32
//   ::_s2_dx_kernel (via _conv3d_s2_dx_impl)     -> conv3d_k3_dx_s2_f32
// which the JAX package runs at fp32 with its `sub = 8` tiling. It computes
// dx[p, ci] = sum_{k, co} g'[(p + 1 - k) / S, co] * w[k, ci, co] over the
// taps k with p + 1 - k a multiple of S, g' zero outside the cotangent's
// volume, with the fusions of the bf16 kernels:
//   CORR  g' = gy + gs[0] + 2 y gs[1] (the statistics' cotangent folded in),
//         built once per staged element in fp32 and never written to
//         memory; the zero padding stays zero after it;
//   POST  dx through the recomputed pre-op: du = dxn * leaky'(x*scale -
//         shift), dx = du * scale, and the per-(sample, channel) sums [sum
//         du*x; sum du] (dst), added in fp64 in a fixed order and rounded
//         to fp32.
//
// Products. mma.sync.m16n8k8.f64 on the FP64 tensor cores: an fp32 operand
// converts to fp64 exactly and the product of two is exact, the sums round
// to nearest in fp64, so dx's only error is its rounding to fp32 (and
// g''s own fp32 rounding under CORR, as the plain version rounds it).
//
// What bounds it on the H100: the FP64 tensor cores, 67 TFLOP/s (stride 1
// at 128^3 x 32 -> 32, N = 2: 232 GFLOP, 3.46 ms; stride 2 at 128^3 x 32
// from 64^3 x 64: 58 GFLOP, 0.87 ms). The first fp32 dx, on register-staged
// tiles, gathered the cotangent voxel p + 1 - k from L2 for every tap (27
// times an element at stride 1), applied the correction at each of those
// reads, staged through registers into a 2-stage ring, and converted each
// operand to fp64 at every fragment read.
//
// Design (conv3d_k3_f32_fwd.cu's, transposed):
//   Units. A unit is a brick of BD x BH x BW dx voxels of one sample x BN
//     dx channels (the GEMM's N, dx's Ci) x a range of the Co / 8 cotangent
//     channel chunks (K; all of them unless K is split). Stride 1, tile
//     "big": 4 x 8 x 8 voxels x 32 channels, the 8 MMA warps 8 x 1 over it
//     (2 x 4 MMA tiles each); tile "small", where every extent is at most
//     4: 4 x 4 x 4 x 64, warps 4 x 2. Stride 2: 8 x 8 x 8 x 16 (4 x 2 MMA
//     tiles a warp).
//   Stride 1. A chunk is 3 steps, one per kd; its first stages the halo'd
//     cotangent brick ((BD+2) x (BH+2) x (BW+2) rows of 8 channels) once,
//     and the taps of every step read it at offset p + 1 - k, 16
//     consecutive dx voxels of a tap being consecutive rows. B[k = co][n =
//     ci] = w[tap, ci, c0:c0 + 8] is 32 contiguous bytes of w's own last
//     axis: each step copies the 9 taps' rows as they lie and converts
//     them without a transpose.
//   Stride 2. dx voxel 2q + p reads g'[q] along an axis of parity 0 (tap
//     1) and g'[q] (tap 2) or g'[q + 1] (tap 0) along one of parity 1
//     (ops/conv3d.py dx_s2_taps), so the (BD/2 + 1) x (BH/2 + 1) x (BW/2 +
//     1) cotangent brick from q0 = (brick origin) / 2 serves all 8 parity
//     classes of the brick's dx voxels: a chunk is one step, staging that
//     brick and the 27 taps' weights once. The 512 rows are the 8 classes'
//     class-local 4 x 4 x 4 sub-bricks, a plane q_d an m-tile of 16; warps
//     2p and 2p + 1 take two planes each of a class of parity p_d = 1 and
//     of one of p_d = 0 (s2_class: 9 taps for the first pair, 6 for the
//     others, against 27 / 4 even), and multiply each m-tile by its own
//     class's 1-8 taps only. Each row takes 27 / 8 taps on average, so a
//     staged weight serves 8x fewer MMAs than at stride 1, and the
//     producers, not the MMAs, bound the step (on an H100: with no MMA at
//     all a 4 x 8 x 8 x 32 tile took 2.16 of its 2.38 ms at 128^3, without
//     the weights' copies 1.69); the 8 x 8 x 8 x 16 tile stages half the
//     weights for the same MMAs (PERF.md: 27-29% faster).
//   Warps. A block is 8 MMA warps and 4 producer warps, one block an SM,
//     persistent over its range of units. The producers issue the cp.async
//     copies of the fp32 rows (16 bytes, zero-filled outside the volume;
//     under CORR y's rows beside gy's) two steps ahead into fp32 slots, and
//     convert each step once into one of two fp64 cotangent bricks and
//     weight buffers while the MMA warps multiply the other; named barriers
//     hand the buffers over ("full": converted, "empty": multiplied). The
//     ring flows across unit boundaries, so one unit's epilogue overlaps
//     the next unit's copies and conversion. At stride 1 a chunk's brick is
//     converted at its first step and copied again only at the next
//     chunk's, so one fp32 slot holds it (two with y), which leaves room for
//     CORR's y at the big tile.
//   Convert once. Under CORR the producers build g' = (gy + gs0) + 2 y gs1
//     where the voxel is inside the volume (a bit per staged half row, kept
//     from the copy) and 0 elsewhere, then convert it to fp64 once. The MMA
//     warps read fragments with 16-byte loads (a lane's two k of an
//     m16n8k8 fragment, t and t + 4, are channels 2t and 2t + 1): A rows
//     and B rows are 64 bytes, so each quarter-warp reads 128 contiguous
//     bytes.
//   Epilogue (unsplit). Rounded to fp32; under POST du = v * leaky'(x *
//     scale - shift), dx = du * scale, and the unit's column sums [sum
//     du*x; sum du] in fp64 (lanes by butterfly, warps along M in order) to
//     slot (sample, brick) of an fp64 scratch, which conv3d_k3_dx_s{1,2}_
//     f32_stats adds in brick order.
//   Split K (ops/conv3d.py _f32_dx_plan: the 8^3 and 4^3 shapes, whose
//     unsplit units do not fill the card). Split s of a unit takes chunks
//     [s * cps, (s + 1) * cps) with all their taps and stores its fp64
//     partial sums to its own slice of a (splits, N, voxels, Ci) scratch;
//     conv3d_k3_dx_s{1,2}_f32_split_finish adds the slices in split order,
//     rounds, then applies POST and stores each block's column sums to its
//     slot, which the stats finish adds in order.
//   Determinism. No atomics: two runs give bit-equal dx and dst.
//
// Requirements (checked by the wrapper and here): Co % 8 == 0, Ci % BN ==
// 0, contiguous 16-byte aligned gy, w, y, x; extents up to 1023; the
// launch's plan (tile, splits, grid, dynamic shared memory) the planner's.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // the 8 MMA warps
constexpr int WARPS = THREADS / 32;
constexpr int PRODUCERS = 128;        // the 4 warps that copy and convert
constexpr int BLOCK = THREADS + PRODUCERS;
// named barriers (0 is __syncthreads): the two fp64 buffers' "full" and
// "empty" (the MMA warps and the producers), the producers alone, the MMA
// warps alone
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5, BAR_MMA = 6;
constexpr int KC = 8;            // cotangent channels per chunk (one MMA k)
constexpr int NST = 3;           // fp32 ring stages: copies run 2 steps ahead
constexpr int NF = 2;            // fp64 buffers: one multiplied, one filled
constexpr int FIN_VOX = 64;      // voxels per block of the split finish
constexpr int STATS_THREADS = 1024;

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
  const float* gy;      // (N, Do, Ho, Wo, Co)
  const float* w;       // (3, 3, 3, Ci, Co)
  const float* y;       // CORR: the forward's output (as gy), or null
  const float* gs;      // CORR: (N, 2, Co)
  const float* x;       // POST: the forward's raw input (as dx), or null
  const float* pre;     // POST: (N, 2, Ci)
  float* dx;            // unsplit: the output
  double* slots;        // unsplit POST: (N, bricks, 2, Ci), or null
  double* part;         // split: (splits, N, D*H*W, Ci)
  int N, D, H, W, Ci, Co;   // dx's extent
  int Do, Ho, Wo;           // the cotangent's
  int nbh, nbw, NB;     // dx bricks per axis (h, w) and per sample
  int ntiles, cps;      // channel tiles; chunks per unit
  int units;
  float slope;
};

// stride 2: class j (0, 1) of the warps of pair p (warps 2p and 2p + 1,
// half of each class's planes each), a parity class 4 p_d + 2 p_h + p_w: a
// class of p_d = 1 (j = 0) and one of p_d = 0 (j = 1), their taps 8 + 1,
// 4 + 2, 4 + 2, 4 + 2 (ops/conv3d.py F32_DX_S2_CLASSES)
__host__ __device__ constexpr int s2_class(int j, int p) {
  return j == 0 ? (p == 0 ? 7 : p == 1 ? 3 : p == 2 ? 5 : 6)
                : (p == 0 ? 0 : p == 1 ? 1 : p == 2 ? 2 : 4);
}

// The tile of a unit: dx brick BD x BH x BW, BN channels, warps WGM along M
// (voxels) x 8 / WGM along N; the staged cotangent brick SD x SH x SW.
template <int S_, int BD_, int BH_, int BW_, int WGM_, int BN_>
struct Cfg {
  static constexpr int S = S_, BD = BD_, BH = BH_, BW = BW_, BN = BN_;
  static constexpr int WGM = WGM_;
  static constexpr int M = BD * BH * BW;
  static constexpr int WGN = WARPS / WGM;
  static constexpr int WM = M / WGM, WN = BN / WGN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  // steps a chunk: stride 1 one per kd, stride 2 one
  static constexpr int SPC = S == 1 ? 3 : 1;
  static constexpr int SD = S == 1 ? BD + 2 : BD / 2 + 1;
  static constexpr int SH = S == 1 ? BH + 2 : BH / 2 + 1;
  static constexpr int SW = S == 1 ? BW + 2 : BW / 2 + 1;
  static constexpr int HROWS = SD * SH * SW;
  // the taps whose weights a step stages
  static constexpr int WTAPS = S == 1 ? 9 : 27;
  // fp32 slots of the cotangent brick: its copy is issued 2 steps before
  // its conversion, after the conversion of the one before it (stride 1:
  // a chunk, 3 steps, before; stride 2: a step)
  static constexpr int NHS = S == 1 ? 1 : NST;
  // shared memory, in this order: NF fp64 cotangent bricks and NF fp64
  // weight steps, the fp32 slots the copies land in (gy's, y's under
  // CORR, the weights'), the producers' inside bits, the column sums
  static constexpr int HF = HROWS * KC;                // doubles
  static constexpr int WF = WTAPS * BN * KC;           // doubles
  static constexpr int HR = HROWS * KC;                // floats a slot
  static constexpr int WR = WTAPS * BN * KC;           // floats a stage
  static constexpr size_t SMEM = (size_t)NF * (HF + WF) * 8 +
                                 (size_t)NHS * HR * 4 + (size_t)NST * WR * 4 +
                                 (size_t)NHS * PRODUCERS * 4 +
                                 (size_t)WGM * 2 * BN * 8;
  static constexpr size_t SMEM_Y = (size_t)NHS * HR * 4;  // CORR's y slots
  static constexpr size_t smem(bool corr) { return SMEM + (corr ? SMEM_Y : 0); }
  static_assert(M % (16 * WGM) == 0 && BN % (8 * WGN) == 0, "whole tiles");
  static_assert(S == 1 || (BH == 8 && BW == 8 && WGM == 8 && MT % 2 == 0),
                "stride 2: 8 classes x BD / 2 m-tiles of 4 x 4, a warp MT "
                "of two classes");
  static_assert(S == 2 || BW % 2 == 0, "a fragment's row pairs");
  static_assert(SMEM + SMEM_Y <= 232448, "227 KB of shared memory");
  static_assert(SPC * NHS >= NST, "a brick's slot is free when reissued");
  static_assert((2 * HROWS + PRODUCERS - 1) / PRODUCERS <= 32,
                "one inside bit per staged half row");
};

struct Unit {
  int split, tile, n, d0, h0, w0;  // dx brick origin
};

// unit u = ((split * ntiles + tile) * N + n) * NB + brick, brick = (bd * nbh
// + bh) * nbw + bw (ops/conv3d.py f32_dx_unit)
template <class C>
__device__ __forceinline__ Unit decode(const Args& a, int u) {
  Unit t;
  int b = u % a.NB, r = u / a.NB;
  t.n = r % a.N;
  r /= a.N;
  t.tile = r % a.ntiles;
  t.split = r / a.ntiles;
  t.w0 = (b % a.nbw) * C::BW;
  b /= a.nbw;
  t.h0 = (b % a.nbh) * C::BH;
  t.d0 = (b / a.nbh) * C::BD;
  return t;
}

// A block's walk over its steps: unit u, its chunk (of cps) and sub-step
// (kd at stride 1), advanced one step at a time, the unit decoded only when
// it changes.
template <class C>
struct Cursor {
  int u, chunk, sub;
  Unit t;
  __device__ Cursor(const Args& a, int u0) : u(u0), chunk(0), sub(0) {
    t = decode<C>(a, u);
  }
  // the chunk's first cotangent channel
  __device__ int c0(const Args& a) const {
    return (t.split * a.cps + chunk) * KC;
  }
  // is this the unit's last step?
  __device__ bool last(const Args& a) const {
    return sub == C::SPC - 1 && chunk == a.cps - 1;
  }
  __device__ void next(const Args& a) {
    if (++sub < C::SPC) return;
    sub = 0;
    if (++chunk < a.cps) return;
    chunk = 0;
    t = decode<C>(a, ++u);
  }
};

template <int V>
struct Int {
  static constexpr int value = V;
};

// Sub-step SUB of a chunk, at compile time. Stride 1: SUB = the row offset
// along d, 2 - kd; its first stages the chunk's brick, whose row r holds
// cotangent voxel (brick origin) - 1 + r, and staged weight i is tap (2 -
// SUB, 2 - i / 3, 2 - i % 3) at row offset (SUB, i / 3, i % 3), since dx
// voxel m reads cotangent voxel m + 1 - k, row m + 2 - k. Stride 2: the one
// step stages the brick from q0 and weight i is tap i.
template <class C, int SUB>
struct Step {
  static constexpr bool HALO = C::S == 2 || SUB == 0;
  __host__ __device__ static constexpr int tap_of(int i) {
    return C::S == 1 ? 26 - (9 * SUB + i) : i;
  }
  __host__ __device__ static constexpr int off(int i) {
    return (SUB * C::SH + i / 3) * C::SW + i % 3;
  }
};

// The taps of stride-2 parity class CLS (ops/conv3d.py dx_s2_taps): along
// an axis of parity 0 tap 1 at cotangent shift 0; of parity 1, by that
// axis's bit of the tap number (d, h, w from the lowest among the odd
// axes), tap 2 at shift 0 or tap 0 at shift 1.
template <int CLS>
struct Class {
  static constexpr int PD = (CLS >> 2) & 1, PH = (CLS >> 1) & 1,
                       PW = CLS & 1;
  static constexpr int TAPS = 1 << (PD + PH + PW);
  __host__ __device__ static constexpr int par(int ax) {
    return ax == 0 ? PD : ax == 1 ? PH : PW;
  }
  __host__ __device__ static constexpr int bit(int i, int ax) {
    return (i >> (ax == 0 ? 0 : ax == 1 ? PD : PD + PH)) & 1;
  }
  __host__ __device__ static constexpr int k(int i, int ax) {
    return par(ax) ? 2 * bit(i, ax) : 1;
  }
  __host__ __device__ static constexpr int s(int i, int ax) {
    return par(ax) ? 1 - bit(i, ax) : 0;
  }
  __host__ __device__ static constexpr int tap(int i) {
    return (k(i, 0) * 3 + k(i, 1)) * 3 + k(i, 2);
  }
  __host__ __device__ static constexpr int off(int i, int sh, int sw) {
    return (s(i, 0) * sh + s(i, 1)) * sw + s(i, 2);
  }
};

// f(Int<SUB>()) for a runtime sub-step
template <class C, class F>
__device__ __forceinline__ void dispatch(int sub, F&& f) {
  if constexpr (C::S == 1) {
    if (sub == 0) f(Int<0>());
    else if (sub == 1) f(Int<1>());
    else f(Int<2>());
  } else {
    f(Int<0>());
  }
}

// the index of a producer thread (threads THREADS .. BLOCK - 1)
__device__ __forceinline__ int ptid() { return threadIdx.x - THREADS; }

// the cotangent voxel of staged row 0
template <class C>
__device__ __forceinline__ void brick_origin(const Unit& t, int* od, int* oh,
                                             int* ow) {
  if (C::S == 1) {
    *od = t.d0 - 1, *oh = t.h0 - 1, *ow = t.w0 - 1;
  } else {
    *od = t.d0 / 2, *oh = t.h0 / 2, *ow = t.w0 / 2;
  }
}

// The copies of a step of sub-step SUB into its fp32 slots: the cotangent
// brick's rows (if the step stages one; y's beside them under CORR), 8
// channels as two 16-byte halves, zero-filled outside the volume, and the
// step's taps' weights, rows (tap, dx channel) of 8 cotangent channels.
// The inside bits of this producer thread's halves go to `bits`.
template <class C, int SUB>
__device__ __forceinline__ void issue(const Args& a, const Unit& t, int c0,
                                      float* graw, float* yraw, float* wraw,
                                      uint32_t* bits) {
  using G = Step<C, SUB>;
  if constexpr (G::HALO) {
    constexpr int ITEMS = C::HROWS * 2;
    const uint32_t gs = smem_u32(graw), ys = smem_u32(yraw);
    const long long s0 = (long long)t.n * a.Do * a.Ho * a.Wo * a.Co + c0;
    int od, oh, ow;
    brick_origin<C>(t, &od, &oh, &ow);
    uint32_t in_bits = 0;
#pragma unroll
    for (int i = 0; i < (ITEMS + PRODUCERS - 1) / PRODUCERS; ++i) {
      const int e = ptid() + i * PRODUCERS;
      if (ITEMS % PRODUCERS == 0 || e < ITEMS) {
        const int row = e >> 1;
        const int rw = row % C::SW, rh = (row / C::SW) % C::SH,
                  rd = row / (C::SW * C::SH);
        const int id = od + rd, ih = oh + rh, iw = ow + rw;
        const bool in = (unsigned)id < (unsigned)a.Do &&
                        (unsigned)ih < (unsigned)a.Ho &&
                        (unsigned)iw < (unsigned)a.Wo;
        const long long o =
            in ? s0 + (((long long)id * a.Ho + ih) * a.Wo + iw) * a.Co +
                     4 * (e & 1)
               : 0;
        cp16(gs + e * 16, a.gy + o, in);
        if (a.y) cp16(ys + e * 16, a.y + o, in);
        in_bits |= (uint32_t)in << i;
      }
    }
    *bits = in_bits;
  }
  const uint32_t ws = smem_u32(wraw);
  const float* wb = a.w + (size_t)t.tile * C::BN * a.Co + c0;
  constexpr int ITEMS = C::WTAPS * C::BN * 2;
#pragma unroll
  for (int q = 0; q < (ITEMS + PRODUCERS - 1) / PRODUCERS; ++q) {
    const int e = ptid() + q * PRODUCERS;
    if (ITEMS % PRODUCERS == 0 || e < ITEMS) {
      const int r = e >> 1, i = r / C::BN, n = r % C::BN;  // r = i * BN + n
      cp16(ws + e * 16,
           wb + ((size_t)G::tap_of(i) * a.Ci + n) * a.Co + 4 * (e & 1), true);
    }
  }
}

// Converts a step's fp32 slots once into the fp64 cotangent brick (under
// CORR g' = (gy + gs0) + 2 y gs1 inside the volume, 0 outside) and weights,
// [tap][dx channel][cotangent channel], that the MMAs read.
template <class C, int SUB>
__device__ __forceinline__ void convert(const Args& a, const Unit& t, int c0,
                                        const float* graw, const float* yraw,
                                        const float* wraw, double* hf,
                                        double* wf, uint32_t in_bits) {
  using G = Step<C, SUB>;
  if constexpr (G::HALO) {
    constexpr int ITEMS = C::HROWS * 2;
    // this thread's halves are all channels c0 + 4 (ptid & 1) .. + 3
    float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0;
    if (a.y) {
      const float* p = a.gs + (size_t)t.n * 2 * a.Co + c0 + 4 * (ptid() & 1);
      g0 = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
      p += a.Co;
      g1 = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
#pragma unroll
    for (int i = 0; i < (ITEMS + PRODUCERS - 1) / PRODUCERS; ++i) {
      const int e = ptid() + i * PRODUCERS;
      if (ITEMS % PRODUCERS == 0 || e < ITEMS) {
        float4 v = reinterpret_cast<const float4*>(graw)[e];
        if (a.y) {
          const float4 u = reinterpret_cast<const float4*>(yraw)[e];
          const bool in = (in_bits >> i) & 1;
          v.x = in ? (v.x + g0.x) + (2.f * u.x) * g1.x : 0.f;
          v.y = in ? (v.y + g0.y) + (2.f * u.y) * g1.y : 0.f;
          v.z = in ? (v.z + g0.z) + (2.f * u.z) * g1.z : 0.f;
          v.w = in ? (v.w + g0.w) + (2.f * u.w) * g1.w : 0.f;
        }
        double2* d = reinterpret_cast<double2*>(hf + e * 4);
        d[0] = make_double2(v.x, v.y);
        d[1] = make_double2(v.z, v.w);
      }
    }
  }
  constexpr int ITEMS = C::WTAPS * C::BN * 2;
#pragma unroll
  for (int q = 0; q < (ITEMS + PRODUCERS - 1) / PRODUCERS; ++q) {
    const int e = ptid() + q * PRODUCERS;
    if (ITEMS % PRODUCERS == 0 || e < ITEMS) {
      const float4 v = reinterpret_cast<const float4*>(wraw)[e];
      double2* d = reinterpret_cast<double2*>(wf + e * 4);
      d[0] = make_double2(v.x, v.y);
      d[1] = make_double2(v.z, v.w);
    }
  }
}

template <class C>
__device__ __forceinline__ void zero(double (&acc)[C::MT][C::NT][4]) {
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;
}

// acc[MI0 .. MI0 + MN) += one tap: A rows rb[mi][h] + off of the brick, B
// the tap's weights, each fragment read once
template <class C, int MI0, int MN>
__device__ __forceinline__ void tap_mma(double (&acc)[C::MT][C::NT][4],
                                        const double* hs, const double* wtap,
                                        const int (&rb)[C::MT][2], int off,
                                        int wn, int g, int t) {
  double af[MN][4], bf[C::NT][2];
#pragma unroll
  for (int m = 0; m < MN; ++m) {
    const double2 lo = *reinterpret_cast<const double2*>(
        hs + (rb[MI0 + m][0] + off) * KC + 2 * t);
    const double2 hi = *reinterpret_cast<const double2*>(
        hs + (rb[MI0 + m][1] + off) * KC + 2 * t);
    af[m][0] = lo.x;
    af[m][1] = hi.x;
    af[m][2] = lo.y;
    af[m][3] = hi.y;
  }
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni) {
    const int n = wn * C::WN + ni * 8 + g;
    const double2 b =
        *reinterpret_cast<const double2*>(wtap + n * KC + 2 * t);
    bf[ni][0] = b.x;
    bf[ni][1] = b.y;
  }
#pragma unroll
  for (int m = 0; m < MN; ++m)
#pragma unroll
    for (int ni = 0; ni < C::NT; ++ni)
      dmma(acc[MI0 + m][ni], af[m], bf[ni]);
}

// the brick-local dx voxel (md, mh, mw) of row r (0..15) of m-tile mi of
// warp wm, and the staged row it reads at tap offset 0. Stride 2: the
// warp's m-tiles [0, MT / 2) are class s2_class(0, wm / 2)'s, [MT / 2, MT)
// class s2_class(1, wm / 2)'s; m-tile mi is the plane q_d = (wm & 1) * MT /
// 2 + mi % (MT / 2) of the class's (BD/2) x 4 x 4 sub-brick, row r its
// voxel (q_h, q_w) = (r / 4, r % 4): dx voxel 2q + p
template <class C>
__device__ __forceinline__ void row_of(int wm, int mi, int r, int* md,
                                       int* mh, int* mw, int* row0) {
  if (C::S == 1) {
    const int m = wm * C::WM + mi * 16 + r;
    *mw = m % C::BW;
    *mh = (m / C::BW) % C::BH;
    *md = m / (C::BW * C::BH);
    *row0 = (*md * C::SH + *mh) * C::SW + *mw;
  } else {
    constexpr int HALF = C::MT / 2;
    const int cls = s2_class(mi / HALF, wm >> 1);
    const int qd = (wm & 1) * HALF + mi % HALF, qh = r >> 2, qw = r & 3;
    *md = 2 * qd + ((cls >> 2) & 1);
    *mh = 2 * qh + ((cls >> 1) & 1);
    *mw = 2 * qw + (cls & 1);
    *row0 = (qd * C::SH + qh) * C::SW + qw;
  }
}

// stride 2: the warp's m-tiles of its pair's class CLS (the first or the
// second half of its m-tiles) += that class's taps
template <class C, int CLS, int MI0>
__device__ __forceinline__ void class_mma(double (&acc)[C::MT][C::NT][4],
                                          const double* hs, const double* ws,
                                          const int (&rb)[C::MT][2], int wn,
                                          int g, int tq) {
  using K = Class<CLS>;
#pragma unroll
  for (int i = 0; i < K::TAPS; ++i)
    tap_mma<C, MI0, C::MT / 2>(acc, hs, ws + K::tap(i) * C::BN * KC, rb,
                               K::off(i, C::SH, C::SW), wn, g, tq);
}

// stride 2: warp pair P's two classes
template <class C, int P>
__device__ __forceinline__ void pair_mma(double (&acc)[C::MT][C::NT][4],
                                         const double* hs, const double* ws,
                                         const int (&rb)[C::MT][2], int wn,
                                         int g, int tq) {
  class_mma<C, s2_class(0, P), 0>(acc, hs, ws, rb, wn, g, tq);
  class_mma<C, s2_class(1, P), C::MT / 2>(acc, hs, ws, rb, wn, g, tq);
}

// acc += step SUB's taps: its brick from hs, its taps' weights from ws
template <class C, int SUB>
__device__ __forceinline__ void mma_step(double (&acc)[C::MT][C::NT][4],
                                         const double* hs, const double* ws,
                                         int wm, int wn, int g, int tq) {
  int rb[C::MT][2];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int md, mh, mw;
      row_of<C>(wm, mi, g + 8 * h, &md, &mh, &mw, &rb[mi][h]);
    }
  if constexpr (C::S == 1) {
    using G = Step<C, SUB>;
#pragma unroll
    for (int i = 0; i < C::WTAPS; ++i)
      tap_mma<C, 0, C::MT>(acc, hs, ws + i * C::BN * KC, rb, G::off(i), wn,
                           g, tq);
  } else {
    switch (wm >> 1) {
      case 0: pair_mma<C, 0>(acc, hs, ws, rb, wn, g, tq); break;
      case 1: pair_mma<C, 1>(acc, hs, ws, rb, wn, g, tq); break;
      case 2: pair_mma<C, 2>(acc, hs, ws, rb, wn, g, tq); break;
      default: pair_mma<C, 3>(acc, hs, ws, rb, wn, g, tq); break;
    }
  }
}

// The unit's epilogue: unsplit, dx (through POST) and POST's slot; split,
// the fp64 partial sums to the split's slice.
template <class C>
__device__ void epilogue(const Args& a, const Unit& t,
                         double (&acc)[C::MT][C::NT][4], double* red,
                         int wm, int wn, int g, int tq) {
  const long long vox = (long long)a.D * a.H * a.W;
  const int ci0 = t.tile * C::BN;
  const bool post = a.pre != nullptr;
  // POST's scale and shift of this thread's columns
  float2 sc[C::NT], sf[C::NT];
  double cs[C::NT][2][2];
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni) {
    sc[ni] = sf[ni] = make_float2(0.f, 0.f);
    if (post && !a.part) {
      const float* p =
          a.pre + (size_t)t.n * 2 * a.Ci + ci0 + wn * C::WN + ni * 8 + 2 * tq;
      sc[ni] = make_float2(__ldg(p), __ldg(p + 1));
      sf[ni] = make_float2(__ldg(p + a.Ci), __ldg(p + a.Ci + 1));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) cs[ni][e][0] = cs[ni][e][1] = 0.0;
  }
  // this thread's rows (dx voxel, -1 outside dx) and under POST their x,
  // all loaded before the first store (a store to dx may alias x)
  long long vr[C::MT][2];
  float2 xs[C::MT][2][C::NT];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int md, mh, mw, row0;
      row_of<C>(wm, mi, g + 8 * h, &md, &mh, &mw, &row0);
      const int pd = t.d0 + md, ph = t.h0 + mh, pw = t.w0 + mw;
      const bool in = pd < a.D && ph < a.H && pw < a.W;
      vr[mi][h] = in ? (long long)t.n * vox +
                           ((long long)pd * a.H + ph) * a.W + pw
                     : -1;
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni)
        xs[mi][h][ni] =
            in && post && !a.part
                ? __ldg(reinterpret_cast<const float2*>(
                      a.x + vr[mi][h] * a.Ci + ci0 + wn * C::WN + ni * 8 +
                      2 * tq))
                : make_float2(0.f, 0.f);
    }
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long v = vr[mi][h];
      if (v < 0) continue;
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni) {
        const int c = ci0 + wn * C::WN + ni * 8 + 2 * tq;
        const double d0 = acc[mi][ni][2 * h], d1 = acc[mi][ni][2 * h + 1];
        if (a.part) {
          *reinterpret_cast<double2*>(
              a.part + ((long long)t.split * a.N * vox + v) * a.Ci + c) =
              make_double2(d0, d1);
          continue;
        }
        float v0 = (float)d0, v1 = (float)d1;
        if (post) {
          const float2 xv = xs[mi][h][ni];
          const float u0 = xv.x * sc[ni].x - sf[ni].x;
          const float u1 = xv.y * sc[ni].y - sf[ni].y;
          const float du0 = u0 >= 0.f ? v0 : v0 * a.slope;
          const float du1 = u1 >= 0.f ? v1 : v1 * a.slope;
          cs[ni][0][0] += (double)du0 * xv.x;
          cs[ni][0][1] += (double)du0;
          cs[ni][1][0] += (double)du1 * xv.y;
          cs[ni][1][1] += (double)du1;
          v0 = du0 * sc[ni].x;
          v1 = du1 * sc[ni].y;
        }
        *reinterpret_cast<float2*>(a.dx + v * a.Ci + c) = make_float2(v0, v1);
      }
    }
  if (!a.slots) return;  // uniform over the MMA warps: no barrier skipped
  // the 8 rows g of a column by butterfly, then the WGM warps along M in
  // order, to slot (n, brick)
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        double v = cs[ni][e][j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        cs[ni][e][j] = v;
      }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < C::NT; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          red[(wm * 2 + j) * C::BN + wn * C::WN + ni * 8 + 2 * tq + e] =
              cs[ni][e][j];
  }
  bar_sync(BAR_MMA, THREADS);
  const int brick = (t.d0 / C::BD * a.nbh + t.h0 / C::BH) * a.nbw +
                    t.w0 / C::BW;
  for (int i = threadIdx.x; i < 2 * C::BN; i += THREADS) {
    const int j = i / C::BN, c = i % C::BN;
    double s = 0.0;
    for (int k = 0; k < C::WGM; ++k) s += red[(k * 2 + j) * C::BN + c];
    a.slots[(((long long)t.n * a.NB + brick) * 2 + j) * a.Ci + ci0 + c] = s;
  }
  bar_sync(BAR_MMA, THREADS);
}

template <class C>
__device__ __forceinline__ void dx_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool corr = a.y != nullptr;
  double* hf = reinterpret_cast<double*>(smem);
  double* wf = hf + NF * C::HF;
  float* gring = reinterpret_cast<float*>(wf + NF * C::WF);
  float* yring = gring + C::NHS * C::HR;
  float* wring = yring + (corr ? C::NHS * C::HR : 0);
  uint32_t* bits = reinterpret_cast<uint32_t*>(wring + NST * C::WR);
  double* red = reinterpret_cast<double*>(bits + C::NHS * PRODUCERS);
  const int u0 = (int)((long long)blockIdx.x * a.units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * a.units / gridDim.x);
  const int steps = (u1 - u0) * a.cps * C::SPC;
  if (steps <= 0) return;
  // the fp64 buffers of step j: its weights (j % NF) and its chunk's
  // cotangent brick (converted at the chunk's first step)
  auto hf_of = [&](int j) { return hf + ((j / C::SPC) % NF) * C::HF; };
  auto wf_of = [&](int j) { return wf + (j % NF) * C::WF; };

  if (threadIdx.x >= THREADS) {
    // the producers: copy step j + NST - 1 while converting step j, each
    // fp64 buffer once the MMA warps are done with its step before
    auto hslot_of = [&](int j) { return (j / C::SPC) % C::NHS; };
    Cursor<C> cs(a, u0), cc(a, u0);  // the step copied, the step converted
    auto stage = [&](int j) {
      const int hs = hslot_of(j);
      dispatch<C>(cs.sub, [&](auto sub) {
        issue<C, decltype(sub)::value>(
            a, cs.t, cs.c0(a), gring + hs * C::HR, yring + hs * C::HR,
            wring + (j % NST) * C::WR, bits + hs * PRODUCERS + ptid());
      });
      cs.next(a);
    };
#pragma unroll
    for (int j = 0; j < NST - 1; ++j) {
      if (j < steps) stage(j);
      cp_commit();
    }
    for (int j = 0; j < steps; ++j, cc.next(a)) {
      const int hs = hslot_of(j);
      cp_wait<NST - 2>();             // this thread's copies of step j
      bar_sync(BAR_PROD, PRODUCERS);  // everyone's; step j - 1 converted
      if (j + NST - 1 < steps) stage(j + NST - 1);
      cp_commit();
      if (j >= NF) bar_sync(BAR_EMPTY + j % NF, BLOCK);
      dispatch<C>(cc.sub, [&](auto sub) {
        convert<C, decltype(sub)::value>(
            a, cc.t, cc.c0(a), gring + hs * C::HR, yring + hs * C::HR,
            wring + (j % NST) * C::WR, hf_of(j), wf_of(j),
            bits[hs * PRODUCERS + ptid()]);
      });
      bar_arrive(BAR_FULL + j % NF, BLOCK);
    }
    return;
  }

  // the MMA warps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % C::WGM, wn = warp / C::WGM;
  const int g = lane >> 2, tq = lane & 3;
  double acc[C::MT][C::NT][4];
  zero<C>(acc);
  Cursor<C> cm(a, u0);
  for (int j = 0; j < steps; ++j, cm.next(a)) {
    const double* hcur = hf_of(j);
    const double* wcur = wf_of(j);
    bar_sync(BAR_FULL + j % NF, BLOCK);
    dispatch<C>(cm.sub, [&](auto sub) {
      mma_step<C, decltype(sub)::value>(acc, hcur, wcur, wm, wn, g, tq);
    });
    if (j + NF < steps) bar_arrive(BAR_EMPTY + j % NF, BLOCK);
    if (cm.last(a)) {
      epilogue<C>(a, cm.t, acc, red, wm, wn, g, tq);
      zero<C>(acc);
    }
  }
}

// split K: dxn = sum of the slices in split order, rounded, then POST;
// block (n, vb, cg) takes voxels [vb * FIN_VOX, +FIN_VOX) of sample n and
// channels [cg * 32, +32), and under POST stores their column sums [sum
// du*x; sum du] to slot (n, vb)
__device__ __forceinline__ void split_finish(const double* __restrict__ part,
                                             const float* __restrict__ x,
                                             const float* __restrict__ pre,
                                             float* __restrict__ dx,
                                             double* __restrict__ slots,
                                             int N, int vox, int Ci,
                                             int splits, float slope) {
  __shared__ double red[WARPS][2][32];
  const int nvb = (vox + FIN_VOX - 1) / FIN_VOX;
  const int n = blockIdx.x / nvb, vb = blockIdx.x % nvb;
  const int c = blockIdx.y * 32 + (threadIdx.x & 31), r = threadIdx.x >> 5;
  const int v1 = min(vox, (vb + 1) * FIN_VOX);
  float sc = 0.f, sf = 0.f;
  if (pre) {
    sc = pre[(long long)n * 2 * Ci + c];
    sf = pre[(long long)n * 2 * Ci + Ci + c];
  }
  double s0 = 0.0, s1 = 0.0;
  for (int v = vb * FIN_VOX + r; v < v1; v += WARPS) {
    const long long o = ((long long)n * vox + v) * Ci + c;
    double s = 0.0;
    for (int k = 0; k < splits; ++k) s += part[(long long)k * N * vox * Ci + o];
    float f = (float)s;
    if (pre) {
      const float xv = x[o];
      const float u = xv * sc - sf;
      const float du = u >= 0.f ? f : f * slope;
      s0 += (double)du * xv;
      s1 += (double)du;
      f = du * sc;
    }
    dx[o] = f;
  }
  if (!slots) return;
  red[r][0][threadIdx.x & 31] = s0;
  red[r][1][threadIdx.x & 31] = s1;
  __syncthreads();
  if (r < 2) {
    double s = 0.0;
    for (int k = 0; k < WARPS; ++k) s += red[k][r][threadIdx.x & 31];
    slots[(((long long)n * nvb + vb) * 2 + r) * Ci + c] = s;
  }
}

// dst[n][j][c] = sum over g < G of slots[n][g][j][c], in a fixed order (32
// strided partial sums, then those in order), rounded to fp32. Block (n,
// cg): channels [cg * 32, +32).
__device__ __forceinline__ void stats_finish(const double* __restrict__ slots,
                                             float* __restrict__ dst, int G,
                                             int Ci) {
  __shared__ double red[32][2][32];
  const int n = blockIdx.x, c = blockIdx.y * 32 + (threadIdx.x & 31);
  const int r = threadIdx.x >> 5;
  double s0 = 0.0, s1 = 0.0;
  for (int k = r; k < G; k += 32) {
    const double* p = slots + (((long long)n * G + k) * 2) * Ci + c;
    s0 += p[0];
    s1 += p[Ci];
  }
  red[r][0][threadIdx.x & 31] = s0;
  red[r][1][threadIdx.x & 31] = s1;
  __syncthreads();
  if (r < 2) {
    double s = 0.0;
    for (int k = 0; k < 32; ++k) s += red[k][r][threadIdx.x & 31];
    dst[((long long)n * 2 + r) * Ci + c] = (float)s;
  }
}

// the entries, named as the wrappers count their launches (the finishes
// after their stride's, so that a profile puts them in its row)
template <class C>
__global__ void __launch_bounds__(BLOCK, 1)
    conv3d_k3_dx_s1_f32(const __grid_constant__ Args a) {
  dx_body<C>(a);
}
template <class C>
__global__ void __launch_bounds__(BLOCK, 1)
    conv3d_k3_dx_s2_f32(const __grid_constant__ Args a) {
  dx_body<C>(a);
}
__global__ void __launch_bounds__(THREADS)
    conv3d_k3_dx_s1_f32_split_finish(const double* part, const float* x,
                                     const float* pre, float* dx,
                                     double* slots, int N, int vox, int Ci,
                                     int splits, float slope) {
  split_finish(part, x, pre, dx, slots, N, vox, Ci, splits, slope);
}
__global__ void __launch_bounds__(THREADS)
    conv3d_k3_dx_s2_f32_split_finish(const double* part, const float* x,
                                     const float* pre, float* dx,
                                     double* slots, int N, int vox, int Ci,
                                     int splits, float slope) {
  split_finish(part, x, pre, dx, slots, N, vox, Ci, splits, slope);
}
__global__ void __launch_bounds__(STATS_THREADS)
    conv3d_k3_dx_s1_f32_stats(const double* slots, float* dst, int G,
                              int Ci) {
  stats_finish(slots, dst, G, Ci);
}
__global__ void __launch_bounds__(STATS_THREADS)
    conv3d_k3_dx_s2_f32_stats(const double* slots, float* dst, int G,
                              int Ci) {
  stats_finish(slots, dst, G, Ci);
}

// the tiles (ops/conv3d.py F32_DX_TILES): stride 1 big, and small for
// extents <= 4; stride 2
using S1Big = Cfg<1, 4, 8, 8, 8, 32>;
using S1Small = Cfg<1, 4, 4, 4, 4, 64>;
using S2Tile = Cfg<2, 8, 8, 8, 8, 16>;

template <class C, class K>
int launch(K kernel, const Args& a, int grid, int smem, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, BLOCK, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <class C>
void geometry(Args* a) {
  a->nbh = (a->H + C::BH - 1) / C::BH;
  a->nbw = (a->W + C::BW - 1) / C::BW;
  a->NB = (a->D + C::BD - 1) / C::BD * a->nbh * a->nbw;
  a->ntiles = a->Ci / C::BN;
}

}  // namespace

// dx (N, D, H, W, Ci) from gy (N, Do, Ho, Wo, Co) and w (3, 3, 3, Ci, Co)
// at `stride`, with CORR (y, gs) and POST (x, pre; dst (N, 2, Ci) fp32;
// slots: fp64 scratch of (N, G, 2, Ci), G = the bricks a sample unsplit, the
// finish blocks a sample split). tile 0: big, tile 1: small (stride 1, Ci %
// 64 == 0), tile 2: stride 2's. splits: a divisor of Co / 8; above 1, part
// is an fp64 scratch
// of (splits, N, D*H*W, Ci). grid: persistent blocks (<= units). smem: the
// block's dynamic shared memory, which must be the tile's in this mode.
extern "C" int conv3d_k3_f32_dx_launch(const void* gy, const void* w,
                                       const void* y, const void* gs,
                                       const void* x, const void* pre,
                                       void* dx, void* dst, void* slots,
                                       void* part, int N, int D, int H,
                                       int W, int Ci, int Co, int stride,
                                       int tile, int splits, int grid,
                                       int smem, float slope, void* stream) {
  if ((stride != 1 && stride != 2) || tile < 0 || tile > 2 ||
      (tile == 2) != (stride == 2) || Co < KC || Co % KC || N < 1 || D < 1 ||
      H < 1 || W < 1 || D > 1023 || H > 1023 || W > 1023 || splits < 1 ||
      (Co / KC) % splits || (y == nullptr) != (gs == nullptr) ||
      (pre == nullptr) != (x == nullptr) ||
      (pre == nullptr) != (dst == nullptr) ||
      (dst == nullptr) != (slots == nullptr) ||
      (splits > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.gy = static_cast<const float*>(gy);
  a.w = static_cast<const float*>(w);
  a.y = static_cast<const float*>(y);
  a.gs = static_cast<const float*>(gs);
  a.x = static_cast<const float*>(x);
  a.pre = static_cast<const float*>(pre);
  a.dx = static_cast<float*>(dx);
  a.slots = splits > 1 ? nullptr : static_cast<double*>(slots);
  a.part = static_cast<double*>(part);
  a.N = N, a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co;
  a.Do = (D - 1) / stride + 1;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.slope = slope;
  a.cps = Co / KC / splits;
  const int bn =
      tile == 1 ? S1Small::BN : tile == 2 ? S2Tile::BN : S1Big::BN;
  if (Ci % bn || Ci % 32) return (int)cudaErrorInvalidValue;
  const bool corr = y != nullptr;
  size_t want;
  if (tile == 1) {
    geometry<S1Small>(&a);
    want = S1Small::smem(corr);
  } else if (stride == 1) {
    geometry<S1Big>(&a);
    want = S1Big::smem(corr);
  } else {
    geometry<S2Tile>(&a);
    want = S2Tile::smem(corr);
  }
  const long long units = (long long)splits * a.ntiles * N * a.NB;
  if (units >= (1ll << 31) || grid < 1 || grid > units ||
      (size_t)smem != want)
    return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (tile == 1)
    rc = launch<S1Small>(conv3d_k3_dx_s1_f32<S1Small>, a, grid, smem, st);
  else if (stride == 1)
    rc = launch<S1Big>(conv3d_k3_dx_s1_f32<S1Big>, a, grid, smem, st);
  else
    rc = launch<S2Tile>(conv3d_k3_dx_s2_f32<S2Tile>, a, grid, smem, st);
  if (rc != 0) return rc;
  const int vox = D * H * W;
  int G = a.NB;
  if (splits > 1) {
    G = (vox + FIN_VOX - 1) / FIN_VOX;
    const dim3 fgrid(N * G, Ci / 32);
    const float* xs = static_cast<const float*>(x);
    const float* ps = static_cast<const float*>(pre);
    float* out = static_cast<float*>(dx);
    double* sl = static_cast<double*>(slots);
    if (stride == 1)
      conv3d_k3_dx_s1_f32_split_finish<<<fgrid, THREADS, 0, st>>>(
          a.part, xs, ps, out, sl, N, vox, Ci, splits, slope);
    else
      conv3d_k3_dx_s2_f32_split_finish<<<fgrid, THREADS, 0, st>>>(
          a.part, xs, ps, out, sl, N, vox, Ci, splits, slope);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (!dst) return 0;
  const dim3 sgrid(N, Ci / 32);
  const double* sl = static_cast<const double*>(slots);
  float* out = static_cast<float*>(dst);
  if (stride == 1)
    conv3d_k3_dx_s1_f32_stats<<<sgrid, STATS_THREADS, 0, st>>>(sl, out, G, Ci);
  else
    conv3d_k3_dx_s2_f32_stats<<<sgrid, STATS_THREADS, 0, st>>>(sl, out, G, Ci);
  return (int)cudaGetLastError();
}
