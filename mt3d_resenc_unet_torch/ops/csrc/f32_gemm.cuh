// fp32-accurate GEMM tiles on the tensor cores. They now serve only the fp32
// upsample's weight gradient (upsample2x_f32.cu's upsample2x_dw_f32, row 9f
// of PERF.md's kernel table); the upsample's forward and dx convert their
// operands once on producer warps instead (upsample2x_f32.cu), and the
// upsample2x_f32.cu primitives use this header's dmma and FastDiv.
//
// Products run on the FP64 tensor cores (mma.sync.m16n8k8.f64): an fp32
// operand converts to fp64 exactly, the fp64 products of two fp32 values
// are exact, and the sums round to nearest in fp64, so a tile's only error
// is the final rounding to fp32, unbiased. Not the split-precision TF32
// route ("3xTF32": hi/lo tf32 halves, three products on the TF32 tensor
// cores): its products are as good (2e-7 to 9e-7 relative L2 against fp64
// at the flagship's shapes), but the TF32 tensor cores' fp32 accumulation
// truncates, and where an input has a large mean (the pre-op'd
// activations) the truncations line up across voxels: on an H100 the
// [sum] statistic of a 64^3 x 64 conv moved by 2.5e-5 of its scale
// (PERF.md §6), over the 1e-5 the fp32 kernels are held to. The card's
// dense FP64 tensor-core peak is 67 TFLOP/s against 165 for 3xTF32 (494.7
// / 3); the tile uses the sm_90 shape m16n8k8, which ran these convs
// faster than the older m8n8k4 (PERF.md §6).
//
// A block is 4 warps, 2 x 2 over a BM x BN output tile; K goes in staged
// chunks of BK = 32. Operands are staged from registers (so a kernel can
// transform them on the way: a pre-op, the stats correction, zero
// padding) into a 2-stage shared-memory ring as fp32, and converted when a
// warp reads its fragments. A is staged "m-major" (rows m, 32 k a row) or
// "k-major" (rows k, BM m a row), B "k-major" (rows k) or "n-major", as the
// global layout is contiguous, so every staged row is filled by 16-byte
// stores. Row pitches are padded (m-/n-major rows 36 floats, k-major rows
// BM + 8 / BN + 8) so the 32 lanes of a fragment read hit 32 banks: A lane
// (g, t) = (lane / 4, lane % 4) reads (m0 + g, k0 + t), at word (m0 + g) *
// 36 + t (bank 4g + t) or (k0 + t) * (BM + 8) + g (bank 8t + g), and B
// likewise.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace f32gemm {

constexpr int THREADS = 128;  // 4 warps: 2 along M x 2 along N
constexpr int BK = 32;        // K of a staged chunk

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// -- the PTX primitives --
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float leaky(float u, float slope) {
  return u >= 0.f ? u : u * slope;
}

// leaky(x * scale - shift), four channels (a producer's norm + LeakyReLU)
__device__ __forceinline__ float4 pre_op(float4 x, float4 sc, float4 sh,
                                         float slope) {
  return make_float4(leaky(x.x * sc.x - sh.x, slope),
                     leaky(x.y * sc.y - sh.y, slope),
                     leaky(x.z * sc.z - sh.z, slope),
                     leaky(x.w * sc.w - sh.w, slope));
}

// gy + gs0 + 2 y gs1: the output cotangent with the [sum; sumsq]
// statistics' cotangent folded in (d sum / dy = 1, d sumsq / dy = 2y)
__device__ __forceinline__ float4 corrected(float4 g, float4 y, float4 a,
                                            float4 b) {
  return make_float4((g.x + a.x) + (2.f * y.x) * b.x,
                     (g.y + a.y) + (2.f * y.y) * b.y,
                     (g.z + a.z) + (2.f * y.z) * b.z,
                     (g.w + a.w) + (2.f * y.w) * b.w);
}

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

// The staged layouts and fragment reads of a BM x BN tile.
template <int BM_, int BN_, bool A_KMAJOR, bool B_KMAJOR>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WM = BM / 2, WN = BN / 2;   // a warp's tile
  static constexpr int MT = WM / 16, NT = WN / 8;  // its 16 x 8 MMA tiles
  static constexpr int A_ROWS = A_KMAJOR ? BK : BM;
  static constexpr int B_ROWS = B_KMAJOR ? BK : BN;
  static constexpr int A_LD = A_KMAJOR ? BM + 8 : BK + 4;
  static constexpr int B_LD = B_KMAJOR ? BN + 8 : BK + 4;
  static constexpr int A_C4 = (A_KMAJOR ? BM : BK) / 4;  // float4s a row
  static constexpr int B_C4 = (B_KMAJOR ? BN : BK) / 4;
  static constexpr int A_LOADS = A_ROWS * A_C4 / THREADS;
  static constexpr int B_LOADS = B_ROWS * B_C4 / THREADS;
  static constexpr int A_FLOATS = A_ROWS * A_LD, B_FLOATS = B_ROWS * B_LD;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_FLOATS = 2 * STAGE;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "a warp holds whole MMA tiles");
  static_assert(A_LOADS * THREADS == A_ROWS * A_C4 &&
                    B_LOADS * THREADS == B_ROWS * B_C4,
                "every thread stages the same number of float4s");
  static_assert(SMEM_FLOATS * 4 <= 48 * 1024, "static shared memory");
  static_assert(THREADS % A_C4 == 0 || A_KMAJOR,
                "an m-major A row's float4 column is the same in every "
                "load of a thread");

  // the staged row and float4 column of this thread's j-th A (B) load
  __device__ static int a_row(int j) {
    return (threadIdx.x + j * THREADS) / A_C4;
  }
  __device__ static int a_c4(int j) {
    return (threadIdx.x + j * THREADS) % A_C4;
  }
  __device__ static int b_row(int j) {
    return (threadIdx.x + j * THREADS) / B_C4;
  }
  __device__ static int b_c4(int j) {
    return (threadIdx.x + j * THREADS) % B_C4;
  }

  __device__ static void store(float* st, const float4 (&ra)[A_LOADS],
                               const float4 (&rb)[B_LOADS]) {
#pragma unroll
    for (int j = 0; j < A_LOADS; ++j)
      *reinterpret_cast<float4*>(st + a_row(j) * A_LD + 4 * a_c4(j)) = ra[j];
#pragma unroll
    for (int j = 0; j < B_LOADS; ++j)
      *reinterpret_cast<float4*>(st + A_FLOATS + b_row(j) * B_LD +
                                 4 * b_c4(j)) = rb[j];
  }

  __device__ static float a_at(const float* st, int m, int k) {
    return A_KMAJOR ? st[k * A_LD + m] : st[m * A_LD + k];
  }
  __device__ static float b_at(const float* st, int k, int n) {
    return B_KMAJOR ? st[A_FLOATS + k * B_LD + n]
                    : st[A_FLOATS + n * B_LD + k];
  }

  // acc += the staged chunk's A (BM x 32) times B (32 x BN), warp (wm, wn)'s
  // part, in fp64
  __device__ static void chunk(const float* st, double (&acc)[MT][NT][4],
                               int wm, int wn, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      double a[MT][4], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int m = wm * WM + mi * 16 + g;
        a[mi][0] = a_at(st, m, kk + t);
        a[mi][1] = a_at(st, m + 8, kk + t);
        a[mi][2] = a_at(st, m, kk + t + 4);
        a[mi][3] = a_at(st, m + 8, kk + t + 4);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = wn * WN + ni * 8 + g;
        b[ni][0] = b_at(st, kk + t, n);
        b[ni][1] = b_at(st, kk + t + 4, n);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) dmma(acc[mi][ni], a[mi], b[ni]);
    }
  }

  // f(m, n, v0, v1) for each pair of adjacent columns (n, n + 1) this
  // thread holds, rounded to fp32: rows m of the tile
  template <class F>
  __device__ static void for_pairs(const double (&acc)[MT][NT][4], F&& f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(wm * WM + mi * 16 + g + 8 * h, wn * WN + ni * 8 + 2 * t,
            (float)acc[mi][ni][2 * h], (float)acc[mi][ni][2 * h + 1]);
  }
};

// acc = the product over K chunks [s0, s1) of what op.load(s, ra, rb)
// stages: the next chunk's global loads are in flight while this one's
// products run, one barrier a chunk.
template <class T, class Op>
__device__ void gemm(const Op& op, float* smem, int s0, int s1,
                     double (&acc)[T::MT][T::NT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;
  if (s0 >= s1) return;
  float4 ra[T::A_LOADS], rb[T::B_LOADS];
  op.load(s0, ra, rb);
  T::store(smem, ra, rb);
  __syncthreads();
  for (int s = s0; s < s1; ++s) {
    const int cur = (s - s0) & 1;
    const bool more = s + 1 < s1;
    if (more) op.load(s + 1, ra, rb);
    T::chunk(smem + cur * T::STAGE, acc, warp >> 1, warp & 1, lane);
    if (more) T::store(smem + (cur ^ 1) * T::STAGE, ra, rb);
    __syncthreads();
  }
}

// The column-tiled (weight gradient) kernels' splits: out[i] = sum over
// s < S of part[s * len + i], in s order.
__global__ void __launch_bounds__(THREADS)
    split_sums_finish(const float* __restrict__ part, float* __restrict__ out,
                      long long len, int S) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[k * len + i];
  out[i] = s;
}

}  // namespace f32gemm
