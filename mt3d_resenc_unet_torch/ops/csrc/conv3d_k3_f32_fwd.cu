// 3x3x3 pad-1 convolution forward on NDHWC fp32, stride 1 or 2, on the FP64
// tensor cores at fp32 accuracy, for Hopper (sm_90a). Plain C interface,
// bound with ctypes (ops/conv3d.py conv3d_k3 on fp32 tensors). Its backward
// is conv3d_k3_f32_dx.cu (dx) and conv3d_k3_f32_dw.cu (dW).
//
// Replaces, at compute dtype float32, the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_conv_kernel (stride 1, via
//     _conv3d_banded_packed_f)                  -> conv3d_k3_s1_f32
//   ::_s2_fwd_kernel (via _conv3d_s2_packed_impl) -> conv3d_k3_s2_f32
// which the JAX package runs at fp32 with its `sub = 8` tiling. It computes
// y[o, co] = sum_{k, ci} xin[S*o - 1 + k, ci] * w[k, ci, co], xin zero
// outside the volume, with the fusions of the bf16 kernels:
//   PRE   xin = leaky(x*scale - shift), applied once per staged element in
//         fp32; the zero padding stays zero after it;
//   ADDIN a second conv's fp32 output added to the rounded sum (the
//         decoder's split-weight pair);
//   STATS [sum; sumsq] of the output (after ADDIN) per (sample, channel),
//         added in fp64 in a fixed order and rounded to fp32.
//
// Products. mma.sync.m16n8k8.f64 on the FP64 tensor cores (wgmma has no
// fp64 form): an fp32 operand converts to fp64 exactly and the product of
// two is exact, the sums round to nearest in fp64, so the output's only
// error is its final rounding to fp32 (upsample2x_f32.cu says why not
// 3xTF32).
//
// What bounds it on the H100: the FP64 tensor cores, 67 TFLOP/s (at 128^3
// x 32 -> 32, N = 2: 232 GFLOP, 3.46 ms; 0.32 ms to move its 1.07 GB).
// At that rate the SM takes one m16n8k8 (1,024 FMAs) every 8 cycles and
// reads 128 bytes of shared memory a cycle, so each fragment byte has to
// serve several MMAs from registers, and L2 can feed ~16 bytes per MMA.
// The first fp32 forward, on register-staged GEMM tiles, gathered every
// voxel from L2 once per tap (27x), staged through registers into a
// 2-stage ring, and converted each operand to fp64 at every fragment read.
//
// Design (the bf16 kernel conv3d_k3_s1.cu's, with operands in fp64, and
// the copies and conversions on warps of their own):
//   Units. A unit is a brick of BD x BH x BW output voxels of one sample x
//     BN output channels x a range of the Ci / 8 input-channel chunks (all
//     of them unless K is split). Tile "big": 4 x 8 x 8 voxels x 32
//     channels, the 8 MMA warps 8 x 1 over it (32 voxels x 32 channels
//     each: 2 x 4 MMA tiles, 512 shared-memory bytes an MMA); tile "small",
//     for extents of at most 4: 4 x 4 x 4 x 64, warps 4 x 2 (16 x 32 each).
//   Steps. Each chunk of 8 input channels is walked in steps. Stride 1: 3
//     steps, one per kd; the first stages the chunk's halo'd input brick
//     ((BD+2) x (BH+2) x (BW+2) rows of 8 channels) once, and each step
//     stages the 9 taps' weights (kd, kh, kw) of the chunk. Stride 2: 8
//     steps, one per parity class of the input footprint (as
//     conv3d_k3_s2.cu stages it): along an axis the even inputs 2o (tap
//     1) make BD rows, the odd ones 2o - 1 .. 2o + 1 (taps 0 and 2) BD + 1
//     rows; a class stages its sub-brick and its 1-8 taps' weights, so the
//     footprint is staged once a chunk and every output w of a tap reads
//     consecutive rows, as at stride 1.
//   Warps. A block is 8 MMA warps and 4 producer warps, one block an SM.
//     The producers issue the cp.async copies of the fp32 rows (16 bytes,
//     zero-filled outside the volume) into a 3-stage ring of halo bricks
//     and a 3-stage ring of weight steps in dynamic shared memory, two
//     steps ahead, and convert each step once into one of two (stride 2:
//     three) fp64 halo bricks and weight buffers while the MMA warps
//     multiply another;
//     named barriers hand the buffers over ("full": converted, "empty":
//     multiplied). The ring flows across unit boundaries, so one unit's
//     epilogue overlaps the next unit's copies and conversion. (On an
//     H100 it ran slower with all 8 warps copying, converting and
//     multiplying in turn, two barriers a step, and with 8 x 8 x 8 bricks,
//     4 x 4 MMA tiles a warp, which spilled at 255 registers.)
//   Convert once. In PRE mode the halo brick gets leaky(x*scale - shift)
//     (fp32, as the plain version) where the voxel is inside the volume (a
//     bit per staged half row, kept from the copy) and 0 elsewhere. The
//     MMA warps read fragments with 16-byte loads: a lane's two k of an
//     m16n8k8 fragment (k = t and t + 4) are channels 2t and 2t + 1,
//     adjacent; A rows are 64-byte brick rows, 16 consecutive output
//     voxels of a tap being consecutive rows, and B rows (one output
//     channel's 8 input channels of a tap) 64 bytes too, so each
//     quarter-warp reads 128 contiguous bytes. The fp32 weight rows are
//     padded by 4 floats, so the conversion's reads of 8 output channels x
//     4 channel pairs hit 32 banks.
//   Epilogue (unsplit). Rounded to fp32, ADDIN added, stored; with STATS the
//     unit's column sums of y and y^2 in fp64 (lanes by butterfly, warps
//     along M in order) go to slot (sample, brick) of an fp64 scratch, and
//     conv3d_k3_s{1,2}_f32_stats adds a sample's slots in brick order.
//   Split K (ops/conv3d.py _f32_fwd_plan: the 8^3 and 4^3 shapes, whose
//     unsplit units do not fill the card). Split s of a unit takes chunks
//     [s * cps, (s + 1) * cps) with all their taps and stores its fp64
//     partial sums to its own slice of a (splits, N, voxels, Co) scratch;
//     conv3d_k3_s{1,2}_f32_split_finish adds the slices in split order,
//     rounds, adds ADDIN and stores y and (STATS) each block's column sums
//     to its slot, which the stats finish adds in order.
//   Determinism. No atomics: two runs give bit-equal y and stats.
//
// Requirements (checked by the wrapper and here): Ci % 8 == 0, Co % BN ==
// 0, contiguous x, w, add_to (8-byte aligned: y and add_to are read and
// written as float2), extents up to 1023.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // the 8 MMA warps
constexpr int WARPS = THREADS / 32;
constexpr int PRODUCERS = 128;        // the 4 warps that copy and convert
constexpr int BLOCK = THREADS + PRODUCERS;
// named barriers (0 is __syncthreads): the fp64 buffers' "full" and
// "empty" (the MMA warps and the producers, up to 3 buffers), the producers
// alone, the MMA warps alone
constexpr int BAR_FULL = 1, BAR_EMPTY = 4, BAR_PROD = 7, BAR_MMA = 8;
constexpr int KC = 8;            // input channels per chunk (one MMA k)
constexpr int NST = 3;           // fp32 ring stages: copies run 2 steps ahead
constexpr int FIN_VOX = 64;      // voxels per block of the split finish
constexpr int STATS_THREADS = 1024;

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

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ float leaky(float u, float slope) {
  return u >= 0.f ? u : u * slope;
}

struct Args {
  const float* x;
  const float* w;
  const float* pre;     // (N, 2, Ci) or null
  const float* add_to;  // (N, Do, Ho, Wo, Co) or null
  float* y;             // unsplit: the output
  double* slots;        // unsplit STATS: (N, bricks, 2, Co), or null
  double* part;         // split: (splits, N, Do*Ho*Wo, Co)
  int N, D, H, W, Ci, Co;
  int Do, Ho, Wo;
  int nbh, nbw, NB;     // output bricks per axis (h, w) and per sample
  int ntiles, cps;      // channel tiles; chunks per unit
  int units;
  float slope;
};

// The tile of a unit: output brick BD x BH x BW, BN channels, warps WGM
// along M (voxels) x 8 / WGM along N.
template <int S_, int BD_, int BH_, int BW_, int WGM_, int BN_>
struct Cfg {
  static constexpr int S = S_, BD = BD_, BH = BH_, BW = BW_, BN = BN_;
  static constexpr int WGM = WGM_;
  static constexpr int M = BD * BH * BW;
  static constexpr int WGN = WARPS / WGM;
  static constexpr int WM = M / WGM, WN = BN / WGN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  // steps a chunk; halo rows (of KC channels) and taps of a step at most
  static constexpr int SPC = S == 1 ? 3 : 8;
  // fp64 buffers: the producers convert up to NF - 1 steps ahead of the
  // MMAs (at stride 1 the halo brick is a chunk's, so 2 of each)
  static constexpr int NF = S == 1 ? 2 : 3;
  static constexpr int HROWS = S == 1 ? (BD + 2) * (BH + 2) * (BW + 2)
                                      : (BD + 1) * (BH + 1) * (BW + 1);
  static constexpr int WTAPS = S == 1 ? 9 : 8;
  // fp32 weight rows (a tap and input channel) padded by 4 floats, so the
  // convert's reads of 8 output channels x 4 channel pairs hit 32 banks
  static constexpr int RWP = BN + 4;
  // shared memory, in this order: NF fp64 halo bricks and NF fp64 weight
  // steps (the MMA warps read one while the producers convert the next),
  // the fp32 rings of halo bricks and weights the copies land in, the
  // producers' inside bits, the column sums
  static constexpr int HF = HROWS * KC;                // doubles
  static constexpr int WF = WTAPS * BN * KC;           // doubles
  static constexpr int HR = HROWS * KC;                // floats a stage
  static constexpr int WR = WTAPS * KC * RWP;          // floats a stage
  static constexpr size_t SMEM =
      (size_t)NF * (HF + WF) * 8 + (size_t)NST * (HR + WR) * 4 +
      (size_t)NST * PRODUCERS * 4 + (size_t)WGM * 2 * BN * 8;
  static_assert(M % (16 * WGM) == 0 && BN % (8 * WGN) == 0, "whole tiles");
  static_assert(BW % 2 == 0, "a fragment's row pairs are adjacent rows");
  static_assert(SMEM <= 232448, "227 KB of shared memory");
};

struct Unit {
  int split, tile, n, d0, h0, w0;  // output brick origin
};

// unit u = ((split * ntiles + tile) * N + n) * NB + brick, brick = (bd * nbh
// + bh) * nbw + bw (ops/conv3d.py f32_fwd_unit)
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
// (kd at stride 1, the parity class at stride 2), advanced one step at a
// time, the unit decoded only when it changes.
template <class C>
struct Cursor {
  int u, chunk, sub;
  Unit t;
  __device__ Cursor(const Args& a, int u0) : u(u0), chunk(0), sub(0) {
    t = decode<C>(a, u);
  }
  __device__ int ci0(const Args& a) const {
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

// The geometry of sub-step SUB, at compile time: its staged sub-brick's
// extent (SD, SH, SW), the input voxel of its first row relative to S *
// (the output brick's origin) (-1 at stride 1; at stride 2 -1 along an odd
// axis, 0 along an even one), and its taps. Stride 1: SUB = kd, the kd = 0
// step staging the chunk's halo brick, taps i = (kd, i / 3, i % 3). Stride
// 2: SUB = the parity class (cd, ch, cw) = (SUB >> 2, SUB >> 1, SUB) & 1,
// whose sub-brick every step stages; an even axis (bit 0) has the inputs
// 2(o0 + r), BD rows, and tap 1 (row offset 0); an odd one the inputs 2(o0
// + r) - 1, BD + 1 rows, and taps 0 and 2 (offsets 0 and 1), tap i's bits
// taken by the odd axes in the order w, h, d from the lowest.
template <class C, int SUB>
struct Step {
  static constexpr int S = C::S;
  static constexpr bool HALO = S == 2 || SUB == 0;
  static constexpr int CD = S == 2 ? (SUB >> 2) & 1 : 1;
  static constexpr int CH = S == 2 ? (SUB >> 1) & 1 : 1;
  static constexpr int CW = S == 2 ? SUB & 1 : 1;
  static constexpr int SD = C::BD + CD + (S == 1 ? 1 : 0);
  static constexpr int SH = C::BH + CH + (S == 1 ? 1 : 0);
  static constexpr int SW = C::BW + CW + (S == 1 ? 1 : 0);
  static constexpr int ROWS = SD * SH * SW;
  static constexpr int TAPS = S == 1 ? 9 : 1 << (CD + CH + CW);
  static_assert(!HALO || ROWS <= C::HROWS, "a slot holds it");
  static_assert((2 * ROWS + PRODUCERS - 1) / PRODUCERS <= 32,
                "one inside bit per staged half row");

  __host__ __device__ static constexpr int bit(int i, int ax) {
    return (i >> ((ax < 2 && CW ? 1 : 0) + (ax < 1 && CH ? 1 : 0))) & 1;
  }
  __host__ __device__ static constexpr int k(int i, int ax) {
    return S == 1 ? (ax == 0 ? SUB : ax == 1 ? i / 3 : i % 3)
                  : ((ax == 0 ? CD : ax == 1 ? CH : CW) ? 2 * bit(i, ax) : 1);
  }
  __host__ __device__ static constexpr int o(int i, int ax) {
    return S == 1 ? k(i, ax)
                  : ((ax == 0 ? CD : ax == 1 ? CH : CW) ? bit(i, ax) : 0);
  }
  __host__ __device__ static constexpr int tap_of(int i) {
    return (k(i, 0) * 3 + k(i, 1)) * 3 + k(i, 2);
  }
  __host__ __device__ static constexpr int off(int i) {
    return (o(i, 0) * SH + o(i, 1)) * SW + o(i, 2);
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
    switch (sub) {
      case 0: f(Int<0>()); break;
      case 1: f(Int<1>()); break;
      case 2: f(Int<2>()); break;
      case 3: f(Int<3>()); break;
      case 4: f(Int<4>()); break;
      case 5: f(Int<5>()); break;
      case 6: f(Int<6>()); break;
      default: f(Int<7>()); break;
    }
  }
}

// the index of a producer thread (threads THREADS .. BLOCK - 1)
__device__ __forceinline__ int ptid() { return threadIdx.x - THREADS; }

// The copies of a step of sub-step SUB into its fp32 ring slots: the halo
// sub-brick's rows (if the step stages one), 8 channels as two 16-byte
// halves, zero-filled outside the volume, and the step's taps' weights,
// rows (tap, input channel) of BN output channels. The inside bits of this
// producer thread's halves go to `bits`.
template <class C, int SUB>
__device__ __forceinline__ void issue(const Args& a, const Unit& t, int ci0,
                                      float* hraw, float* wraw,
                                      uint32_t* bits) {
  using G = Step<C, SUB>;
  if constexpr (G::HALO) {
    constexpr int ITEMS = G::ROWS * 2;
    const uint32_t hs = smem_u32(hraw);
    const float* xs = a.x + (size_t)t.n * a.D * a.H * a.W * a.Ci + ci0;
    const int od = C::S * t.d0 - (C::S == 1 ? 1 : G::CD);
    const int oh = C::S * t.h0 - (C::S == 1 ? 1 : G::CH);
    const int ow = C::S * t.w0 - (C::S == 1 ? 1 : G::CW);
    uint32_t in_bits = 0;
#pragma unroll
    for (int i = 0; i < (ITEMS + PRODUCERS - 1) / PRODUCERS; ++i) {
      const int e = ptid() + i * PRODUCERS;
      if (ITEMS % PRODUCERS == 0 || e < ITEMS) {
        const int row = e >> 1;
        const int rw = row % G::SW, rh = (row / G::SW) % G::SH,
                  rd = row / (G::SW * G::SH);
        const int id = od + C::S * rd, ih = oh + C::S * rh,
                  iw = ow + C::S * rw;
        const bool in = (unsigned)id < (unsigned)a.D &&
                        (unsigned)ih < (unsigned)a.H &&
                        (unsigned)iw < (unsigned)a.W;
        const float* src =
            in ? xs + (((size_t)id * a.H + ih) * a.W + iw) * a.Ci +
                     4 * (e & 1)
               : a.x;
        cp16(hs + e * 16, src, in);
        in_bits |= (uint32_t)in << i;
      }
    }
    *bits = in_bits;
  }
  const uint32_t ws = smem_u32(wraw);
  const float* wb = a.w + (size_t)ci0 * a.Co + t.tile * C::BN;
  constexpr int ITEMS = G::TAPS * KC * (C::BN / 4);
#pragma unroll
  for (int q = 0; q < (ITEMS + PRODUCERS - 1) / PRODUCERS; ++q) {
    const int e = ptid() + q * PRODUCERS;
    if (ITEMS % PRODUCERS == 0 || e < ITEMS) {
      const int c4 = e % (C::BN / 4), r = e / (C::BN / 4);  // r = i * 8 + k
      const int i = r >> 3, k = r & 7;
      cp16(ws + (r * C::RWP + 4 * c4) * 4,
           wb + ((size_t)G::tap_of(i) * a.Ci + k) * a.Co + 4 * c4, true);
    }
  }
}

// Converts a step's fp32 slots once into the fp64 halo brick (with the
// pre-op in PRE mode, zero where the voxel is outside the volume) and
// weights, [tap][output channel][input channel], that the MMAs read.
template <class C, int SUB>
__device__ __forceinline__ void convert(const Args& a, const Unit& t, int ci0,
                                        const float* hraw, const float* wraw,
                                        double* hf, double* wf,
                                        uint32_t in_bits) {
  using G = Step<C, SUB>;
  if constexpr (G::HALO) {
    constexpr int ITEMS = G::ROWS * 2;
    // this thread's halves are all channels 4 (ptid & 1) .. + 3
    float4 sc = make_float4(0.f, 0.f, 0.f, 0.f), sh = sc;
    if (a.pre) {
      const float* p =
          a.pre + (size_t)t.n * 2 * a.Ci + ci0 + 4 * (ptid() & 1);
      sc = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
      p += a.Ci;
      sh = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
#pragma unroll
    for (int i = 0; i < (ITEMS + PRODUCERS - 1) / PRODUCERS; ++i) {
      const int e = ptid() + i * PRODUCERS;
      if (ITEMS % PRODUCERS == 0 || e < ITEMS) {
        float4 v = reinterpret_cast<const float4*>(hraw)[e];
        if (a.pre) {
          const bool in = (in_bits >> i) & 1;
          v.x = in ? leaky(v.x * sc.x - sh.x, a.slope) : 0.f;
          v.y = in ? leaky(v.y * sc.y - sh.y, a.slope) : 0.f;
          v.z = in ? leaky(v.z * sc.z - sh.z, a.slope) : 0.f;
          v.w = in ? leaky(v.w * sc.w - sh.w, a.slope) : 0.f;
        }
        double2* d = reinterpret_cast<double2*>(hf + e * 4);
        d[0] = make_double2(v.x, v.y);
        d[1] = make_double2(v.z, v.w);
      }
    }
  }
  // pairs (i, n, p): input channels 2p, 2p + 1 of output channel n, tap i
  constexpr int PAIRS = G::TAPS * C::BN * 4;
#pragma unroll
  for (int q = 0; q < (PAIRS + PRODUCERS - 1) / PRODUCERS; ++q) {
    const int e = ptid() + q * PRODUCERS;
    if (PAIRS % PRODUCERS == 0 || e < PAIRS) {
      const int p = e & 3, n = (e >> 2) % C::BN, i = (e >> 2) / C::BN;
      const float* r = wraw + (i * KC + 2 * p) * C::RWP + n;
      reinterpret_cast<double2*>(wf)[e] = make_double2(r[0], r[C::RWP]);
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

// acc += one tap: A rows rb[mi][h] + off of the halo slot, B the tap's
// weights (i-th of the slot)
template <class C>
__device__ __forceinline__ void tap_mma(double (&acc)[C::MT][C::NT][4],
                                        const double* hslot,
                                        const double* wtap,
                                        const int (&rb)[C::MT][2], int off,
                                        int wn, int g, int t) {
  double af[C::MT][4], bf[C::NT][2];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
    const double2 lo = *reinterpret_cast<const double2*>(
        hslot + (rb[mi][0] + off) * KC + 2 * t);
    const double2 hi = *reinterpret_cast<const double2*>(
        hslot + (rb[mi][1] + off) * KC + 2 * t);
    af[mi][0] = lo.x;
    af[mi][1] = hi.x;
    af[mi][2] = lo.y;
    af[mi][3] = hi.y;
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
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NT; ++ni) dmma(acc[mi][ni], af[mi], bf[ni]);
}

// the output voxel (md, mh, mw) of unit row m
template <class C>
__device__ __forceinline__ void row_of(int m, int* md, int* mh, int* mw) {
  *mw = m % C::BW;
  *mh = (m / C::BW) % C::BH;
  *md = m / (C::BW * C::BH);
}

// acc += step P's taps: its sub-brick from hs, its taps' weights from ws
template <class C, class P>
__device__ __forceinline__ void mma_step(double (&acc)[C::MT][C::NT][4],
                                         const double* hs, const double* ws,
                                         int wm, int wn, int g, int tq) {
  int rb[C::MT][2];
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int md, mh, mw;
      row_of<C>(wm * C::WM + mi * 16 + g + 8 * h, &md, &mh, &mw);
      rb[mi][h] = (md * P::SH + mh) * P::SW + mw;
    }
#pragma unroll
  for (int i = 0; i < P::TAPS; ++i)
    tap_mma<C>(acc, hs, ws + i * C::BN * KC, rb, P::off(i), wn, g, tq);
}

// The unit's epilogue: unsplit, y (+ ADDIN) and the STATS slot; split, the
// fp64 partial sums to the split's slice.
template <class C>
__device__ void epilogue(const Args& a, const Unit& t,
                         double (&acc)[C::MT][C::NT][4], double* red,
                         int wm, int wn, int g, int tq) {
  const long long vox = (long long)a.Do * a.Ho * a.Wo;
  const int co0 = t.tile * C::BN;
  double cs[C::NT][2][2];
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) cs[ni][e][0] = cs[ni][e][1] = 0.0;
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int md, mh, mw;
      row_of<C>(wm * C::WM + mi * 16 + g + 8 * h, &md, &mh, &mw);
      const int od = t.d0 + md, oh = t.h0 + mh, ow = t.w0 + mw;
      if (od >= a.Do || oh >= a.Ho || ow >= a.Wo) continue;
      const long long v =
          (long long)t.n * vox + ((long long)od * a.Ho + oh) * a.Wo + ow;
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni) {
        const int c = co0 + wn * C::WN + ni * 8 + 2 * tq;
        const double d0 = acc[mi][ni][2 * h], d1 = acc[mi][ni][2 * h + 1];
        if (a.part) {
          *reinterpret_cast<double2*>(
              a.part + ((long long)t.split * a.N * vox + v) * a.Co + c) =
              make_double2(d0, d1);
          continue;
        }
        float v0 = (float)d0, v1 = (float)d1;
        if (a.add_to) {
          const float2 q =
              *reinterpret_cast<const float2*>(a.add_to + v * a.Co + c);
          v0 += q.x;
          v1 += q.y;
        }
        *reinterpret_cast<float2*>(a.y + v * a.Co + c) = make_float2(v0, v1);
        cs[ni][0][0] += (double)v0;
        cs[ni][0][1] += (double)v0 * v0;
        cs[ni][1][0] += (double)v1;
        cs[ni][1][1] += (double)v1 * v1;
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
    a.slots[(((long long)t.n * a.NB + brick) * 2 + j) * a.Co + co0 + c] = s;
  }
  bar_sync(BAR_MMA, THREADS);
}

template <class C>
__device__ __forceinline__ void fwd_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* hf = reinterpret_cast<double*>(smem);
  double* wf = hf + C::NF * C::HF;
  float* hring = reinterpret_cast<float*>(wf + C::NF * C::WF);
  float* wring = hring + NST * C::HR;
  uint32_t* bits = reinterpret_cast<uint32_t*>(wring + NST * C::WR);
  double* red = reinterpret_cast<double*>(bits + NST * PRODUCERS);
  const int u0 = (int)((long long)blockIdx.x * a.units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * a.units / gridDim.x);
  const int steps = (u1 - u0) * a.cps * C::SPC;
  if (steps <= 0) return;
  // the fp64 buffers of step j: its weights (j % NF) and its halo brick,
  // the chunk's at stride 1 (converted at the chunk's kd = 0 step), the
  // step's own at stride 2
  auto hf_of = [&](int j) {
    return hf + (C::S == 1 ? (j / 3) % C::NF : j % C::NF) * C::HF;
  };
  auto wf_of = [&](int j) { return wf + (j % C::NF) * C::WF; };

  if (threadIdx.x >= THREADS) {
    // the producers: copy step j + NST - 1 while converting step j, each
    // fp64 buffer once the MMA warps are done with its step before
    auto hslot_of = [&](int j) {
      return (C::S == 1 ? (j / 3) % NST : j % NST);
    };
    Cursor<C> cs(a, u0), cc(a, u0);  // the step copied, the step converted
    auto stage = [&](int j) {
      const int hs = hslot_of(j);
      dispatch<C>(cs.sub, [&](auto sub) {
        issue<C, decltype(sub)::value>(
            a, cs.t, cs.ci0(a), hring + hs * C::HR,
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
      cp_wait<NST - 2>();         // this thread's copies of step j
      bar_sync(BAR_PROD, PRODUCERS);  // everyone's; step j - 1 converted
      if (j + NST - 1 < steps) stage(j + NST - 1);
      cp_commit();
      if (j >= C::NF) bar_sync(BAR_EMPTY + j % C::NF, BLOCK);
      dispatch<C>(cc.sub, [&](auto sub) {
        convert<C, decltype(sub)::value>(
            a, cc.t, cc.ci0(a), hring + hs * C::HR,
            wring + (j % NST) * C::WR, hf_of(j), wf_of(j),
            bits[hs * PRODUCERS + ptid()]);
      });
      bar_arrive(BAR_FULL + j % C::NF, BLOCK);
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
    bar_sync(BAR_FULL + j % C::NF, BLOCK);
    dispatch<C>(cm.sub, [&](auto sub) {
      mma_step<C, Step<C, decltype(sub)::value>>(acc, hcur, wcur, wm, wn, g,
                                                    tq);
    });
    if (j + C::NF < steps) bar_arrive(BAR_EMPTY + j % C::NF, BLOCK);
    if (cm.last(a)) {
      epilogue<C>(a, cm.t, acc, red, wm, wn, g, tq);
      zero<C>(acc);
    }
  }
}

// split K: y = sum of the slices in split order, rounded, + ADDIN; block
// (n, vb, cg) takes voxels [vb * FIN_VOX, +FIN_VOX) of sample n and
// channels [cg * 32, +32), and with STATS stores their column sums to slot
// (n, vb)
__device__ __forceinline__ void split_finish(const double* __restrict__ part,
                                             const float* __restrict__ add_to,
                                             float* __restrict__ y,
                                             double* __restrict__ slots,
                                             int N, int vox, int Co,
                                             int splits) {
  __shared__ double red[WARPS][2][32];
  const int nvb = (vox + FIN_VOX - 1) / FIN_VOX;
  const int n = blockIdx.x / nvb, vb = blockIdx.x % nvb;
  const int c = blockIdx.y * 32 + (threadIdx.x & 31), r = threadIdx.x >> 5;
  const int v1 = min(vox, (vb + 1) * FIN_VOX);
  double s0 = 0.0, s1 = 0.0;
  for (int v = vb * FIN_VOX + r; v < v1; v += WARPS) {
    const long long o = ((long long)n * vox + v) * Co + c;
    double s = 0.0;
    for (int k = 0; k < splits; ++k) s += part[(long long)k * N * vox * Co + o];
    float f = (float)s;
    if (add_to) f += add_to[o];
    y[o] = f;
    s0 += (double)f;
    s1 += (double)f * f;
  }
  if (!slots) return;
  red[r][0][threadIdx.x & 31] = s0;
  red[r][1][threadIdx.x & 31] = s1;
  __syncthreads();
  if (r < 2) {
    double s = 0.0;
    for (int k = 0; k < WARPS; ++k) s += red[k][r][threadIdx.x & 31];
    slots[(((long long)n * nvb + vb) * 2 + r) * Co + c] = s;
  }
}

// stats[n][j][c] = sum over g < G of slots[n][g][j][c], in a fixed order
// (32 strided partial sums, then those in order), rounded to fp32. Block
// (n, cg): channels [cg * 32, +32).
__device__ __forceinline__ void stats_finish(const double* __restrict__ slots,
                                             float* __restrict__ stats, int G,
                                             int Co) {
  __shared__ double red[32][2][32];
  const int n = blockIdx.x, c = blockIdx.y * 32 + (threadIdx.x & 31);
  const int r = threadIdx.x >> 5;
  double s0 = 0.0, s1 = 0.0;
  for (int k = r; k < G; k += 32) {
    const double* p = slots + (((long long)n * G + k) * 2) * Co + c;
    s0 += p[0];
    s1 += p[Co];
  }
  red[r][0][threadIdx.x & 31] = s0;
  red[r][1][threadIdx.x & 31] = s1;
  __syncthreads();
  if (r < 2) {
    double s = 0.0;
    for (int k = 0; k < 32; ++k) s += red[k][r][threadIdx.x & 31];
    stats[((long long)n * 2 + r) * Co + c] = (float)s;
  }
}

// the entries, named as the wrappers count their launches (the finishes
// after their stride's, so that a profile puts them in its row)
template <class C>
__global__ void __launch_bounds__(BLOCK, 1)
    conv3d_k3_s1_f32(const __grid_constant__ Args a) {
  fwd_body<C>(a);
}
template <class C>
__global__ void __launch_bounds__(BLOCK, 1)
    conv3d_k3_s2_f32(const __grid_constant__ Args a) {
  fwd_body<C>(a);
}
__global__ void __launch_bounds__(THREADS)
    conv3d_k3_s1_f32_split_finish(const double* part, const float* add_to,
                                  float* y, double* slots, int N, int vox,
                                  int Co, int splits) {
  split_finish(part, add_to, y, slots, N, vox, Co, splits);
}
__global__ void __launch_bounds__(THREADS)
    conv3d_k3_s2_f32_split_finish(const double* part, const float* add_to,
                                  float* y, double* slots, int N, int vox,
                                  int Co, int splits) {
  split_finish(part, add_to, y, slots, N, vox, Co, splits);
}
__global__ void __launch_bounds__(STATS_THREADS)
    conv3d_k3_s1_f32_stats(const double* slots, float* stats, int G, int Co) {
  stats_finish(slots, stats, G, Co);
}
__global__ void __launch_bounds__(STATS_THREADS)
    conv3d_k3_s2_f32_stats(const double* slots, float* stats, int G, int Co) {
  stats_finish(slots, stats, G, Co);
}

// the tiles (ops/conv3d.py F32_FWD_TILES): big, and small for extents <= 4
using S1Big = Cfg<1, 4, 8, 8, 8, 32>;
using S1Small = Cfg<1, 4, 4, 4, 4, 64>;
using S2Big = Cfg<2, 4, 8, 8, 8, 32>;

template <class C, class K>
int launch(K kernel, const Args& a, int grid, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, BLOCK, C::SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <class C>
void geometry(Args* a) {
  a->nbh = (a->Ho + C::BH - 1) / C::BH;
  a->nbw = (a->Wo + C::BW - 1) / C::BW;
  a->NB = (a->Do + C::BD - 1) / C::BD * a->nbh * a->nbw;
  a->ntiles = a->Co / C::BN;
}

}  // namespace

// y (N, Do, Ho, Wo, Co) = conv(x (N, D, H, W, Ci), w (3, 3, 3, Ci, Co)) at
// `stride`, with PRE (pre), ADDIN (add_to) and STATS (stats (N, 2, Co) fp32;
// slots: fp64 scratch of (N, G, 2, Co), G = the bricks a sample unsplit, the
// finish blocks a sample split). tile 0: big, tile 1: small (stride 1, Co %
// 64 == 0). splits: a divisor of Ci / 8; above 1, part is an fp64 scratch of
// (splits, N, Do*Ho*Wo, Co). grid: persistent blocks (<= units).
extern "C" int conv3d_k3_f32_fwd_launch(const void* x, const void* w,
                                        const void* pre, const void* add_to,
                                        void* y, void* stats, void* slots,
                                        void* part, int N, int D, int H,
                                        int W, int Ci, int Co, int stride,
                                        int tile, int splits, int grid,
                                        float slope, void* stream) {
  if ((stride != 1 && stride != 2) || (tile != 0 && tile != 1) ||
      (tile == 1 && stride != 1) || Ci < KC || Ci % KC || N < 1 ||
      D < 1 || H < 1 || W < 1 || D > 1023 || H > 1023 || W > 1023 ||
      splits < 1 || (Ci / KC) % splits || (stats == nullptr) != (slots == nullptr) ||
      (splits > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.pre = static_cast<const float*>(pre);
  a.add_to = static_cast<const float*>(add_to);
  a.y = static_cast<float*>(y);
  a.slots = splits > 1 ? nullptr : static_cast<double*>(slots);
  a.part = static_cast<double*>(part);
  a.N = N, a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co;
  a.Do = (D - 1) / stride + 1;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.slope = slope;
  a.cps = Ci / KC / splits;
  const int bn = tile == 1 ? S1Small::BN : S1Big::BN;
  if (Co % bn || Co % 32) return (int)cudaErrorInvalidValue;
  if (tile == 1) geometry<S1Small>(&a);
  else if (stride == 1) geometry<S1Big>(&a);
  else geometry<S2Big>(&a);
  const long long units = (long long)splits * a.ntiles * N * a.NB;
  if (units >= (1ll << 31) || grid < 1 || grid > units)
    return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (tile == 1) rc = launch<S1Small>(conv3d_k3_s1_f32<S1Small>, a, grid, st);
  else if (stride == 1) rc = launch<S1Big>(conv3d_k3_s1_f32<S1Big>, a, grid, st);
  else rc = launch<S2Big>(conv3d_k3_s2_f32<S2Big>, a, grid, st);
  if (rc != 0) return rc;
  const int vox = a.Do * a.Ho * a.Wo;
  int G = a.NB;
  if (splits > 1) {
    G = (vox + FIN_VOX - 1) / FIN_VOX;
    const dim3 fgrid(N * G, Co / 32);
    double* sl = static_cast<double*>(slots);
    if (stride == 1)
      conv3d_k3_s1_f32_split_finish<<<fgrid, THREADS, 0, st>>>(
          a.part, a.add_to, a.y, sl, N, vox, Co, splits);
    else
      conv3d_k3_s2_f32_split_finish<<<fgrid, THREADS, 0, st>>>(
          a.part, a.add_to, a.y, sl, N, vox, Co, splits);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (!stats) return 0;
  const dim3 sgrid(N, Co / 32);
  const double* sl = static_cast<const double*>(slots);
  float* out = static_cast<float*>(stats);
  if (stride == 1)
    conv3d_k3_s1_f32_stats<<<sgrid, STATS_THREADS, 0, st>>>(sl, out, G, Co);
  else
    conv3d_k3_s2_f32_stats<<<sgrid, STATS_THREADS, 0, st>>>(sl, out, G, Co);
  return (int)cudaGetLastError();
}
