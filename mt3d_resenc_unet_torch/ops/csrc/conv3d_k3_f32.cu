// The weight gradient (dW) of the 3x3x3 pad-1 convolution on NDHWC fp32,
// stride 1 or 2, on the tensor cores at fp32 accuracy (FP64 MMA,
// f32_gemm.cuh), for Hopper (sm_90a). Plain C interface, bound with ctypes
// (ops/conv3d.py conv3d_k3_dw on fp32 tensors). The forward is
// conv3d_k3_f32_fwd.cu, dx conv3d_k3_f32_dx.cu; the bf16 kernels of the
// same function are conv3d_k3_dw_{s1,s2}.cu.
//
// Replaces, at compute dtype float32, the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_dw_kernel -> conv3d_k3_dw_s1_f32
//   ::_s2_dw_kernel                              -> conv3d_k3_dw_s2_f32
// which the JAX package runs at any compute dtype (its fp32 tiling branch:
// pallas_conv.py `sub = 16 if bf16 else 8`). With their fusions: PRE, xin =
// leaky(x*scale - shift) per staged element, the zero padding applied after
// it, and CORR, the cotangent gy + gs0 + 2 y gs1 built as it is staged.
//
// What bounds them on the H100: the tensor cores. An fp32-accurate product
// takes three TF32 ones on the card's fastest route (3xTF32), so a conv of
// F FLOPs needs at least 3F / 494.7 TFLOP/s (at 128^3 x 32 -> 32, N = 2:
// 232 GFLOP, 1.41 ms) against 0.32 ms to move its 1.07 GB of fp32 input
// and output; on the FP64 tensor cores these kernels use, F / 67 TFLOP/s
// (3.46 ms).
//
// Design: implicit GEMMs over f32gemm::Tile, 4 warps a block: M = 3 taps
// (kd, kh, all kw) x 32 input channels, N = output channels, K = all output
// voxels of the batch in chunks of 32; the staged cotangent serves the
// three taps. K is split across blocks so that the card fills and no block
// sums more than 512 chunks; each split stores its (27, Ci, Co) partial to
// its own slice, and split_sums_finish adds the slices in split order.
// Determinism. No atomics: two runs give bit-equal dW.
#include "f32_gemm.cuh"

using namespace f32gemm;

namespace {

struct Geom {
  int N, D, H, W;     // the input's extent
  int Do, Ho, Wo;     // the output's
  int Ci, Co;
};

__device__ __forceinline__ bool inside(int d, int h, int w, int D, int H,
                                       int W) {
  return (unsigned)d < (unsigned)D && (unsigned)h < (unsigned)H &&
         (unsigned)w < (unsigned)W;
}

struct DwArgs {
  const float* x;
  const float* gy;
  const float* pre;  // (N, 2, Ci) or null
  const float* y;    // CORR or null
  const float* gs;
  float* part;       // (splits, 27, Ci, Co); dW itself at one split
  Geom g;
  float slope;
  int nch, splits;   // K chunks of 32 output voxels, and their splits
  FastDiv vo, hwo, wo;  // Do*Ho*Wo, Ho*Wo, Wo
};

template <class T, int S>
struct DwOp {
  const DwArgs* a;
  int kd, kh, ci0, n0, K;

  __device__ DwOp(const DwArgs& a_, int tg, int ct, int nt) : a(&a_) {
    kd = tg / 3, kh = tg % 3;
    ci0 = ct * 32;
    n0 = nt * T::BN;
    K = a_.g.N * a_.g.Do * a_.g.Ho * a_.g.Wo;
  }

  __device__ void load(int s, float4 (&ra)[T::A_LOADS],
                       float4 (&rb)[T::B_LOADS]) const {
    const Geom& g = a->g;
    const int v0 = s * BK;
    // A[k = voxel][m = kw * 32 + ci]: the input under tap (kd, kh, kw)
#pragma unroll
    for (int j = 0; j < T::A_LOADS; ++j) {
      float4 v = zero4();
      const int vox = v0 + T::a_row(j);
      if (vox < K) {
        const int n = fdiv(vox, a->vo), o = vox - n * (int)a->vo.d;
        const int od = fdiv(o, a->hwo), r = o - od * (int)a->hwo.d;
        const int oh = fdiv(r, a->wo), ow = r - oh * (int)a->wo.d;
        const int c4 = T::a_c4(j), kw = c4 >> 3, c = ci0 + 4 * (c4 & 7);
        const int id = od * S + kd - 1, ih = oh * S + kh - 1,
                  iw = ow * S + kw - 1;
        if (inside(id, ih, iw, g.D, g.H, g.W)) {
          v = ld4(a->x +
                  ((((long long)n * g.D + id) * g.H + ih) * g.W + iw) * g.Ci +
                  c);
          if (a->pre) {
            const float* ps = a->pre + (long long)n * 2 * g.Ci + c;
            v = pre_op(v, ld4(ps), ld4(ps + g.Ci), a->slope);
          }
        }
      }
      ra[j] = v;
    }
    // B[k = voxel][n = co]: the (corrected) cotangent
#pragma unroll
    for (int j = 0; j < T::B_LOADS; ++j) {
      float4 v = zero4();
      const int vox = v0 + T::b_row(j);
      if (vox < K) {
        const int c = n0 + 4 * T::b_c4(j);
        const long long o = (long long)vox * g.Co + c;
        v = ld4(a->gy + o);
        if (a->y) {
          const float* gsn = a->gs + (long long)fdiv(vox, a->vo) * 2 * g.Co;
          v = corrected(v, ld4(a->y + o), ld4(gsn + c), ld4(gsn + g.Co + c));
        }
      }
      rb[j] = v;
    }
  }
};

template <class T, int S>
__device__ __forceinline__ void conv_dw(const DwArgs& a) {
  __shared__ __align__(16) float smem[T::SMEM_FLOATS];
  const int cts = a.g.Ci / 32;
  const int tg = blockIdx.x / cts, ct = blockIdx.x % cts;
  const int nt = blockIdx.y, sp = blockIdx.z;
  const int s0 = (int)((long long)sp * a.nch / a.splits);
  const int s1 = (int)((long long)(sp + 1) * a.nch / a.splits);
  double acc[T::MT][T::NT][4];
  const DwOp<T, S> op(a, tg, ct, nt);
  gemm<T>(op, smem, s0, s1, acc);
  const int Ci = a.g.Ci, Co = a.g.Co;
  float* out = a.part + (long long)sp * 27 * Ci * Co;
  T::for_pairs(acc, [&](int m, int c, float v0, float v1) {
    const int tap = tg * 3 + (m >> 5), ci = ct * 32 + (m & 31);
    *reinterpret_cast<float2*>(
        out + ((long long)tap * Ci + ci) * Co + nt * T::BN + c) =
        make_float2(v0, v1);
  });
}

// the entries, named as the wrappers count their launches
template <class T>
__global__ void __launch_bounds__(THREADS)
    conv3d_k3_dw_s1_f32(const __grid_constant__ DwArgs a) {
  conv_dw<T, 1>(a);
}
template <class T>
__global__ void __launch_bounds__(THREADS)
    conv3d_k3_dw_s2_f32(const __grid_constant__ DwArgs a) {
  conv_dw<T, 2>(a);
}

using DwWide = Tile<96, 64, true, true>;
using DwNarrow = Tile<96, 32, true, true>;

bool extent_ok(int D, int H, int W) {
  return D >= 1 && H >= 1 && W >= 1 && D <= 1023 && H <= 1023 && W <= 1023;
}

Geom geom(int N, int D, int H, int W, int Ci, int Co, int stride) {
  Geom g;
  g.N = N, g.D = D, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
  g.Do = (D - 1) / stride + 1;
  g.Ho = (H - 1) / stride + 1;
  g.Wo = (W - 1) / stride + 1;
  return g;
}

}  // namespace

// dW (3, 3, 3, Ci, Co) fp32 = sum over the batch's output voxels of the
// (pre-op'd) input under each tap times the (corrected) cotangent. part:
// (splits, 27, Ci, Co) scratch, null at one split (dW written directly).
extern "C" int conv3d_k3_f32_dw_launch(const void* x, const void* gy,
                                       const void* pre, const void* y,
                                       const void* gs, void* dw, void* part,
                                       int N, int D, int H, int W, int Ci,
                                       int Co, int stride, int bn, int splits,
                                       float slope, void* stream) {
  if ((stride != 1 && stride != 2) || Ci % 32 || !(bn == 32 || bn == 64) ||
      Co % bn || N < 1 || !extent_ok(D, H, W) || splits < 1 ||
      (y == nullptr) != (gs == nullptr) || (splits > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  DwArgs a;
  a.x = static_cast<const float*>(x);
  a.gy = static_cast<const float*>(gy);
  a.pre = static_cast<const float*>(pre);
  a.y = static_cast<const float*>(y);
  a.gs = static_cast<const float*>(gs);
  a.part = static_cast<float*>(splits > 1 ? part : dw);
  a.g = geom(N, D, H, W, Ci, Co, stride);
  a.slope = slope;
  const long long K = (long long)N * a.g.Do * a.g.Ho * a.g.Wo;
  if (K >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  a.nch = (int)((K + BK - 1) / BK);
  if (splits > a.nch) return (int)cudaErrorInvalidValue;
  a.splits = splits;
  a.vo = fast_div((unsigned)(a.g.Do * a.g.Ho * a.g.Wo));
  a.hwo = fast_div((unsigned)(a.g.Ho * a.g.Wo));
  a.wo = fast_div((unsigned)a.g.Wo);
  const dim3 grid(9 * (Ci / 32), Co / bn, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) {
    if (stride == 1) conv3d_k3_dw_s1_f32<DwWide><<<grid, THREADS, 0, st>>>(a);
    else conv3d_k3_dw_s2_f32<DwWide><<<grid, THREADS, 0, st>>>(a);
  } else {
    if (stride == 1) conv3d_k3_dw_s1_f32<DwNarrow><<<grid, THREADS, 0, st>>>(a);
    else conv3d_k3_dw_s2_f32<DwNarrow><<<grid, THREADS, 0, st>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long len = 27LL * Ci * Co;
  split_sums_finish<<<(unsigned)((len + THREADS - 1) / THREADS), THREADS, 0,
                      st>>>(a.part, static_cast<float*>(dw), len, splits);
  return (int)cudaGetLastError();
}
