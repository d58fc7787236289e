// The 2x2x2 transposed conv (kernel == stride) on NDHWC fp32 and its
// backward, on the tensor cores at fp32 accuracy (FP64 MMA, f32_gemm.cuh),
// for Hopper (sm_90a). Plain C interface, bound with ctypes (ops/upsample.py:
// upsample2x, upsample2x_dx and upsample2x_dw on fp32 tensors). The bf16
// kernels of the same functions are upsample2x.cu and upsample2x_bwd.cu.
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
// for the 8 parities p = (a, b, c) and coarse voxels q.
//
// What bounds them on the H100: at the flagship's 128 -> 64 at 32^3 and
// 64 -> 32 at 64^3 (N = 2) a pass does 2.1 GFLOP, 13 us at the 3xTF32
// peak (32 us on the FP64 tensor cores these kernels use), against 50 to
// 170 MB of fp32 operands, 15 to 50 us of HBM.
//
// Design: GEMMs over f32gemm::Tile, 4 warps a block.
//   Forward: M = one sample's coarse voxels, N = 8 x Co (a channel tile
//     lies in one parity), K = Ci; the epilogue writes each row to its fine
//     voxel 2q + p.
//   dx: M = one sample's coarse voxels, N = Ci, K = 8 parities x Co; a
//     chunk's A rows are gy at 2q + p of its parity.
//   Both walk their m-tiles by block (b, nt, n) over tiles [b * mtiles /
//     nb, (b + 1) * mtiles / nb).
//   dW: M = Ci tile, N = Co tile, K = all coarse voxels of the batch in
//     chunks of 32, one parity a block, split across blocks; each split
//     stores its (8, Ci, Co) partial to its own slice and split_sums_finish
//     adds them in split order. No atomics: two runs are bit-equal.
#include "f32_gemm.cuh"

using namespace f32gemm;

namespace {

struct UpArgs {
  const float* a;  // forward, dW: x (N, D, H, W, Ci); dx: gy
  const float* b;  // forward, dx: wf (2, 2, 2, Ci, Co); dW: gy
  float* out;      // y, dx, or dW's (splits, 8, Ci, Co) partials
  int N, D, H, W, Ci, Co;
  int mtiles;          // forward, dx
  int nch, splits;     // dW: K chunks of 32 coarse voxels, their splits
  FastDiv vox, hw, w;  // D*H*W, H*W, W
};

// the fine voxel (2q + p) of coarse row r of a sample, as an index into the
// (2D, 2H, 2W) volume
__device__ __forceinline__ long long fine(int r, int p, int D, int H, int W) {
  const int hw = H * W;
  const int qd = r / hw, qh = (r % hw) / W, qw = r % W;
  return ((long long)(2 * qd + (p >> 2)) * 2 * H + 2 * qh + ((p >> 1) & 1)) *
             2 * W + 2 * qw + (p & 1);
}

template <class T>
struct UpFwdOp {
  const float* xs;
  const float* wf;
  int Ci, Co, n0, p, rows, m0;

  __device__ UpFwdOp(const UpArgs& a, int n, int nt, int m0_)
      : Ci(a.Ci), Co(a.Co), m0(m0_) {
    rows = a.D * a.H * a.W;
    xs = a.a + (long long)n * rows * Ci;
    wf = a.b;
    const int ct = Co / T::BN;
    p = nt / ct;
    n0 = (nt % ct) * T::BN;
  }

  __device__ int chunks() const { return Ci / BK; }

  __device__ void load(int s, float4 (&ra)[T::A_LOADS],
                       float4 (&rb)[T::B_LOADS]) const {
    const int c0 = s * BK;
#pragma unroll
    for (int j = 0; j < T::A_LOADS; ++j) {
      const int m = m0 + T::a_row(j);
      ra[j] = m < rows ? ld4(xs + (long long)m * Ci + c0 + 4 * T::a_c4(j))
                       : zero4();
    }
#pragma unroll
    for (int j = 0; j < T::B_LOADS; ++j)
      rb[j] = ld4(wf + ((long long)p * Ci + c0 + T::b_row(j)) * Co + n0 +
                  4 * T::b_c4(j));
  }
};

// the entries are named as the wrappers count their launches
template <class T>
__global__ void __launch_bounds__(THREADS)
    upsample2x_f32(const __grid_constant__ UpArgs a) {
  __shared__ __align__(16) float smem[T::SMEM_FLOATS];
  const int n = blockIdx.z, nt = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int mt0 = (int)((long long)b * a.mtiles / nb);
  const int mt1 = (int)((long long)(b + 1) * a.mtiles / nb);
  const long long fine_sample = 8LL * a.D * a.H * a.W * a.Co * n;
  double acc[T::MT][T::NT][4];
  for (int mt = mt0; mt < mt1; ++mt) {
    const UpFwdOp<T> op(a, n, nt, mt * T::BM);
    gemm<T>(op, smem, 0, op.chunks(), acc);
    T::for_pairs(acc, [&](int m, int c, float v0, float v1) {
      const int r = op.m0 + m;
      if (r >= op.rows) return;
      const long long o = fine_sample +
                          fine(r, op.p, a.D, a.H, a.W) * a.Co + op.n0 + c;
      *reinterpret_cast<float2*>(a.out + o) = make_float2(v0, v1);
    });
  }
}

template <class T>
struct UpDxOp {
  const float* gys;
  const float* wf;
  int D, H, W, Ci, Co, n0, cchunks;
  int pos[T::A_LOADS];  // coarse row, -1 past the sample

  __device__ UpDxOp(const UpArgs& a, int n, int nt, int m0)
      : D(a.D), H(a.H), W(a.W), Ci(a.Ci), Co(a.Co) {
    const int rows = D * H * W;
    gys = a.a + 8LL * n * rows * Co;
    wf = a.b;
    n0 = nt * T::BN;
    cchunks = Co / BK;
#pragma unroll
    for (int j = 0; j < T::A_LOADS; ++j) {
      const int m = m0 + T::a_row(j);
      pos[j] = m < rows ? m : -1;
    }
  }

  __device__ int chunks() const { return 8 * cchunks; }

  __device__ void load(int s, float4 (&ra)[T::A_LOADS],
                       float4 (&rb)[T::B_LOADS]) const {
    const int p = s / cchunks, c0 = (s - p * cchunks) * BK;
#pragma unroll
    for (int j = 0; j < T::A_LOADS; ++j)
      ra[j] = pos[j] >= 0
                  ? ld4(gys + fine(pos[j], p, D, H, W) * Co + c0 +
                        4 * T::a_c4(j))
                  : zero4();
    // B[k = co][n = ci] = wf[p, ci, co]: staged n-major
#pragma unroll
    for (int j = 0; j < T::B_LOADS; ++j)
      rb[j] = ld4(wf + ((long long)p * Ci + n0 + T::b_row(j)) * Co + c0 +
                  4 * T::b_c4(j));
  }
};

template <class T>
__global__ void __launch_bounds__(THREADS)
    upsample2x_dx_f32(const __grid_constant__ UpArgs a) {
  __shared__ __align__(16) float smem[T::SMEM_FLOATS];
  const int n = blockIdx.z, nt = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int rows = a.D * a.H * a.W;
  const int mt0 = (int)((long long)b * a.mtiles / nb);
  const int mt1 = (int)((long long)(b + 1) * a.mtiles / nb);
  double acc[T::MT][T::NT][4];
  for (int mt = mt0; mt < mt1; ++mt) {
    const int m0 = mt * T::BM;
    const UpDxOp<T> op(a, n, nt, m0);
    gemm<T>(op, smem, 0, op.chunks(), acc);
    float* out = a.out + ((long long)n * rows + m0) * a.Ci + nt * T::BN;
    T::for_pairs(acc, [&](int m, int c, float v0, float v1) {
      if (m0 + m >= rows) return;
      *reinterpret_cast<float2*>(out + (long long)m * a.Ci + c) =
          make_float2(v0, v1);
    });
  }
}

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

using FwdWide = Tile<64, 64, false, true>;
using FwdNarrow = Tile<128, 32, false, true>;
using DxWide = Tile<64, 64, false, false>;
using DxNarrow = Tile<128, 32, false, false>;
using DwWW = Tile<64, 64, true, true>;  // dW: bm x bn
using DwWN = Tile<64, 32, true, true>;
using DwNW = Tile<32, 64, true, true>;
using DwNN = Tile<32, 32, true, true>;

bool shape_ok(int N, int D, int H, int W, int Ci, int Co) {
  return N >= 1 && D >= 1 && H >= 1 && W >= 1 && Ci % BK == 0 &&
         Co % BK == 0 && (long long)N * 8 * D * H * W < (1ll << 31);
}

UpArgs args(const void* a, const void* b, void* out, int N, int D, int H,
            int W, int Ci, int Co) {
  UpArgs u{};
  u.a = static_cast<const float*>(a);
  u.b = static_cast<const float*>(b);
  u.out = static_cast<float*>(out);
  u.N = N, u.D = D, u.H = H, u.W = W, u.Ci = Ci, u.Co = Co;
  return u;
}

}  // namespace

// y (N, 2D, 2H, 2W, Co) from x (N, D, H, W, Ci) and the flipped wf (2, 2,
// 2, Ci, Co); bn: 64 (Co % 64 == 0) or 32; nb blocks a (sample, channel
// tile of one parity).
extern "C" int upsample2x_f32_launch(const void* x, const void* wf, void* y,
                                     int N, int D, int H, int W, int Ci,
                                     int Co, int bn, int nb, void* stream) {
  if (!shape_ok(N, D, H, W, Ci, Co) || !(bn == 32 || bn == 64) || Co % bn ||
      nb < 1)
    return (int)cudaErrorInvalidValue;
  UpArgs a = args(x, wf, y, N, D, H, W, Ci, Co);
  const int bm = bn == 64 ? FwdWide::BM : FwdNarrow::BM;
  a.mtiles = (D * H * W + bm - 1) / bm;
  if (nb > a.mtiles) return (int)cudaErrorInvalidValue;
  const dim3 grid(nb, 8 * Co / bn, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) upsample2x_f32<FwdWide><<<grid, THREADS, 0, st>>>(a);
  else upsample2x_f32<FwdNarrow><<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// dx (N, D, H, W, Ci) from gy (N, 2D, 2H, 2W, Co) and wf; bn by Ci.
extern "C" int upsample2x_f32_dx_launch(const void* gy, const void* wf,
                                        void* dx, int N, int D, int H, int W,
                                        int Ci, int Co, int bn, int nb,
                                        void* stream) {
  if (!shape_ok(N, D, H, W, Ci, Co) || !(bn == 32 || bn == 64) || Ci % bn ||
      nb < 1)
    return (int)cudaErrorInvalidValue;
  UpArgs a = args(gy, wf, dx, N, D, H, W, Ci, Co);
  const int bm = bn == 64 ? DxWide::BM : DxNarrow::BM;
  a.mtiles = (D * H * W + bm - 1) / bm;
  if (nb > a.mtiles) return (int)cudaErrorInvalidValue;
  const dim3 grid(nb, Ci / bn, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) upsample2x_dx_f32<DxWide><<<grid, THREADS, 0, st>>>(a);
  else upsample2x_dx_f32<DxNarrow><<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// dwf (2, 2, 2, Ci, Co) fp32 from x and gy; bm 64 (Ci % 64 == 0) or 32,
// bn 64 (Co % 64 == 0) or 32; part: (splits, 8, Ci, Co) scratch, null at
// one split (dW written directly).
extern "C" int upsample2x_f32_dw_launch(const void* x, const void* gy,
                                        void* dw, void* part, int N, int D,
                                        int H, int W, int Ci, int Co, int bm,
                                        int bn, int splits, void* stream) {
  if (!shape_ok(N, D, H, W, Ci, Co) || !(bm == 32 || bm == 64) || Ci % bm ||
      !(bn == 32 || bn == 64) || Co % bn || splits < 1 ||
      (splits > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  UpArgs a = args(x, gy, splits > 1 ? part : dw, N, D, H, W, Ci, Co);
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
