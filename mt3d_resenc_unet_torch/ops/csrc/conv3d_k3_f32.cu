// The backward of the 3x3x3 pad-1 convolution on NDHWC fp32, stride 1 or
// 2, on the tensor cores at fp32 accuracy (FP64 MMA, f32_gemm.cuh), for
// Hopper (sm_90a). Plain C interface, bound with ctypes (ops/conv3d.py:
// conv3d_k3_dx and conv3d_k3_dw on fp32 tensors). The forward is
// conv3d_k3_f32_fwd.cu; the bf16 kernels of the same functions are
// conv3d_k3_{s1,s2,dx_s1,dx_s2,dw_s1,dw_s2}.cu.
//
// Replaces, at compute dtype float32, the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_conv_kernel in its corr/post
//     mode (_conv3d_dx_fused_f)                 -> conv3d_k3_dx_s1_f32
//   ::_s2_dx_kernel                              -> conv3d_k3_dx_s2_f32
//   ::_dw_kernel                                 -> conv3d_k3_dw_s1_f32
//   ::_s2_dw_kernel                              -> conv3d_k3_dw_s2_f32
// which the JAX package runs at any compute dtype (its fp32 tiling branch:
// pallas_conv.py `sub = 16 if bf16 else 8`). With their fusions:
//   dx       CORR  the cotangent gy + gs0 + 2 y gs1 built as it is staged,
//                  never written to memory;
//            POST  dx through the recomputed pre-op: du = dxn * leaky'(u),
//                  dx = du * scale, and [sum du*x; sum du];
//   dW       PRE   xin = leaky(x*scale - shift) per staged element, the zero
//                  padding applied after it, and CORR, on its two operands.
//
// What bounds them on the H100: the tensor cores. An fp32-accurate product
// takes three TF32 ones on the card's fastest route (3xTF32), so a conv of
// F FLOPs needs at least 3F / 494.7 TFLOP/s (at 128^3 x 32 -> 32, N = 2:
// 232 GFLOP, 1.41 ms) against 0.32 ms to move its 1.07 GB of fp32 input
// and output; on the FP64 tensor cores these kernels use, F / 67 TFLOP/s
// (3.46 ms).
//
// Design: implicit GEMMs over f32gemm::Tile, 4 warps a block.
//   dx (conv_dx): M = the voxels of one sample (at stride 2, of one parity
//     class p of dx voxels 2q + p, whose taps are fixed: 1 along an axis of
//     parity 0, 2 along one of parity 1, so no zero tap is multiplied),
//     N = the input channels, K = taps x the output channels in chunks of
//     32. The A rows are a gather: row m's tap k reads cotangent voxel m +
//     1 - k (stride 1) or zeros outside the volume. A tile is 128 x 32 or
//     64 x 64 (N = 32, or a multiple of 64). Block (b, nt, z) walks the
//     m-tiles [b * mtiles / nb, (b + 1) * mtiles / nb) of sample (and
//     class) z, keeping its columns' sums in registers, and stores them
//     once to slot (z, b) of an fp32 scratch; column_sums_finish adds a
//     sample's slots in order.
//   dW (conv_dw): M = 3 taps (kd, kh, all kw) x 32 input channels,
//     N = output channels, K = all output voxels of the batch in chunks of
//     32; the staged cotangent serves the three taps. K is split across
//     blocks so that the card fills and no block sums more than 512 chunks;
//     each split stores its (27, Ci, Co) partial to its own slice, and
//     split_sums_finish adds the slices in split order.
//   Determinism. No atomics: two runs give bit-equal outputs, statistics
//   and dW.
#include "f32_gemm.cuh"

using namespace f32gemm;

namespace {

struct Geom {
  int N, D, H, W;     // the input's extent (dx: dx's)
  int Do, Ho, Wo;     // the output's (dx: gy's)
  int Ci, Co;
};

// (d, h, w) packed 10 bits each; -1: no voxel
__device__ __forceinline__ int pack(int d, int h, int w) {
  return (d << 20) | (h << 10) | w;
}
__device__ __forceinline__ int pd_(int p) { return p >> 20; }
__device__ __forceinline__ int ph_(int p) { return (p >> 10) & 1023; }
__device__ __forceinline__ int pw_(int p) { return p & 1023; }

__device__ __forceinline__ bool inside(int d, int h, int w, int D, int H,
                                       int W) {
  return (unsigned)d < (unsigned)D && (unsigned)h < (unsigned)H &&
         (unsigned)w < (unsigned)W;
}

// ---------------------------------------------------------------------------
// dx
// ---------------------------------------------------------------------------

struct DxArgs {
  const float* gy;
  const float* w;
  const float* y;    // CORR: the forward's output, or null
  const float* gs;   // CORR: (N, 2, Co)
  const float* x;    // POST: the forward's raw input, or null
  const float* pre;  // POST: (N, 2, Ci)
  float* dx;
  float* part;       // POST: (N, classes, nb, 2, Ci) column sums
  Geom g;
  float slope;
  int mtiles;
};

// the extent of parity class p (0 or 1) of an axis of E dx voxels
__device__ __forceinline__ int class_extent(int E, int p) {
  return (E - p + 1) / 2;
}

template <class T, int S>
struct DxOp {
  const float* gys;  // the sample's cotangent
  const float* ys;   // its forward output (CORR) or null
  const float* gsn;  // its stats cotangent (CORR)
  const float* w;
  int Do, Ho, Wo, Ci, Co, n0, cchunks, taps;
  int par;           // stride 2: the class's parity bits (d << 2 | h << 1 | w)
  int pos[T::A_LOADS];  // dx voxel (stride 1) or class voxel (stride 2)

  __device__ DxOp(const DxArgs& a, int z, int nt, int m0)
      : Do(a.g.Do), Ho(a.g.Ho), Wo(a.g.Wo), Ci(a.g.Ci), Co(a.g.Co) {
    const int n = S == 1 ? z : z >> 3;
    par = S == 1 ? 0 : z & 7;
    const long long off = (long long)n * Do * Ho * Wo * Co;
    gys = a.gy + off;
    ys = a.y ? a.y + off : nullptr;
    gsn = a.gs ? a.gs + (long long)n * 2 * Co : nullptr;
    w = a.w;
    n0 = nt * T::BN;
    cchunks = Co / BK;
    int ed = a.g.D, eh = a.g.H, ew = a.g.W;
    taps = 27;
    if (S == 2) {
      ed = class_extent(ed, par >> 2);
      eh = class_extent(eh, (par >> 1) & 1);
      ew = class_extent(ew, par & 1);
      taps = 1 << (((par >> 2) & 1) + ((par >> 1) & 1) + (par & 1));
    }
    const int hw = eh * ew, rows = ed * hw;
#pragma unroll
    for (int j = 0; j < T::A_LOADS; ++j) {
      const int m = m0 + T::a_row(j);
      pos[j] = m < rows ? pack(m / hw, (m % hw) / ew, m % ew) : -1;
    }
  }

  __device__ int chunks() const { return taps * cchunks; }

  __device__ void load(int s, float4 (&ra)[T::A_LOADS],
                       float4 (&rb)[T::B_LOADS]) const {
    const int ti = s / cchunks, c0 = (s - ti * cchunks) * BK;
    // tap k along each axis, and the cotangent voxel's offset from the row's
    // voxel: stride 1, q = p + 1 - k; stride 2 (class voxel q' of parity
    // p, dx voxel 2q' + p), q = q' + sh: k = 1, sh = 0 at parity 0; at
    // parity 1 the class tap's next bit b (d, h, w from the lowest): k = 2,
    // sh = 0 if b, else k = 0, sh = 1 (ops/conv3d.py dx_s2_taps)
    int k[3], sh[3];
    if (S == 1) {
      k[0] = ti / 9, k[1] = (ti / 3) % 3, k[2] = ti % 3;
#pragma unroll
      for (int i = 0; i < 3; ++i) sh[i] = 1 - k[i];
    } else {
      int bits = ti;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if ((par >> (2 - i)) & 1) {
          const int b = bits & 1;
          bits >>= 1;
          k[i] = b ? 2 : 0;
          sh[i] = b ? 0 : 1;
        } else {
          k[i] = 1;
          sh[i] = 0;
        }
      }
    }
    const int tap = (k[0] * 3 + k[1]) * 3 + k[2];
    // every A row a thread stages holds the same 4 channels (m-major rows
    // of 8 float4s): their gs vectors load once a chunk
    const int c = c0 + 4 * T::a_c4(0);
    float4 g0 = zero4(), g1 = zero4();
    if (ys) g0 = ld4(gsn + c), g1 = ld4(gsn + Co + c);
#pragma unroll
    for (int j = 0; j < T::A_LOADS; ++j) {
      float4 v = zero4();
      const int p = pos[j];
      const int qd = pd_(p) + sh[0], qh = ph_(p) + sh[1], qw = pw_(p) + sh[2];
      if (p >= 0 && inside(qd, qh, qw, Do, Ho, Wo)) {
        const long long o = (((long long)qd * Ho + qh) * Wo + qw) * Co + c;
        v = ld4(gys + o);
        if (ys) v = corrected(v, ld4(ys + o), g0, g1);
      }
      ra[j] = v;
    }
    // B[k = co][n = ci] = w[tap, ci, co]: staged n-major, rows of 32 co
#pragma unroll
    for (int j = 0; j < T::B_LOADS; ++j)
      rb[j] = ld4(w + ((long long)tap * Ci + n0 + T::b_row(j)) * Co + c0 +
                  4 * T::b_c4(j));
  }
};

template <class T, int S>
__device__ __forceinline__ void conv_dx(const DxArgs& a) {
  __shared__ __align__(16) float smem[T::SMEM_FLOATS];
  const int z = blockIdx.z, nt = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int n = S == 1 ? z : z >> 3, par = S == 1 ? 0 : z & 7;
  const int D = a.g.D, H = a.g.H, W = a.g.W, Ci = a.g.Ci;
  const int pd = par >> 2, ph = (par >> 1) & 1, pw = par & 1;
  const int ed = S == 1 ? D : class_extent(D, pd);
  const int eh = S == 1 ? H : class_extent(H, ph);
  const int ew = S == 1 ? W : class_extent(W, pw);
  const int rows = ed * eh * ew;
  const int mtiles = imin(a.mtiles, (rows + T::BM - 1) / T::BM);
  const int mt0 = (int)((long long)b * mtiles / nb);
  const int mt1 = (int)((long long)(b + 1) * mtiles / nb);
  const long long sample = (long long)n * D * H * W * Ci;
  const float* ps = a.pre ? a.pre + (long long)n * 2 * Ci : nullptr;
  float cs[T::NT][2][2] = {};
  double acc[T::MT][T::NT][4];
  for (int mt = mt0; mt < mt1; ++mt) {
    const int m0 = mt * T::BM;
    const DxOp<T, S> op(a, z, nt, m0);
    gemm<T>(op, smem, 0, op.chunks(), acc);
    T::for_pairs(acc, [&](int m, int c, int ni, float v0, float v1) {
      const int r = m0 + m;
      if (r >= rows) return;
      long long vox = r;
      if (S == 2) {
        const int hw = eh * ew;
        vox = ((long long)(2 * (r / hw) + pd) * H + 2 * ((r % hw) / ew) + ph) *
                  W + 2 * (r % ew) + pw;
      }
      const int ci = nt * T::BN + c;
      const long long o = sample + vox * Ci + ci;
      if (ps) {
        const float2 xv = *reinterpret_cast<const float2*>(a.x + o);
        const float2 sc = *reinterpret_cast<const float2*>(ps + ci);
        const float2 sf = *reinterpret_cast<const float2*>(ps + Ci + ci);
        const float u0 = xv.x * sc.x - sf.x, u1 = xv.y * sc.y - sf.y;
        const float d0 = u0 >= 0.f ? v0 : v0 * a.slope;
        const float d1 = u1 >= 0.f ? v1 : v1 * a.slope;
        cs[ni][0][0] += d0 * xv.x;
        cs[ni][0][1] += d0;
        cs[ni][1][0] += d1 * xv.y;
        cs[ni][1][1] += d1;
        v0 = d0 * sc.x;
        v1 = d1 * sc.y;
      }
      *reinterpret_cast<float2*>(a.dx + o) = make_float2(v0, v1);
    });
  }
  if (a.part)
    T::column_sums(cs, smem,
                   a.part + ((long long)z * nb + b) * 2 * Ci + nt * T::BN,
                   Ci);
}

// ---------------------------------------------------------------------------
// dW
// ---------------------------------------------------------------------------

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
  T::for_pairs(acc, [&](int m, int c, int, float v0, float v1) {
    const int tap = tg * 3 + (m >> 5), ci = ct * 32 + (m & 31);
    *reinterpret_cast<float2*>(
        out + ((long long)tap * Ci + ci) * Co + nt * T::BN + c) =
        make_float2(v0, v1);
  });
}

// the entries, named as the wrappers count their launches
template <class T>
__global__ void __launch_bounds__(THREADS)
    conv3d_k3_dx_s1_f32(const __grid_constant__ DxArgs a) {
  conv_dx<T, 1>(a);
}
template <class T>
__global__ void __launch_bounds__(THREADS)
    conv3d_k3_dx_s2_f32(const __grid_constant__ DxArgs a) {
  conv_dx<T, 2>(a);
}
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

using WideT = Tile<64, 64, false, false>;    // dx: B staged n-major
using NarrowT = Tile<128, 32, false, false>;
using DwWide = Tile<96, 64, true, true>;
using DwNarrow = Tile<96, 32, true, true>;

int rows_tiles(long long rows, int bm) { return (int)((rows + bm - 1) / bm); }

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

int finish_columns(float* part, float* out, int N, int T, int C,
                   cudaStream_t st) {
  const int total = N * 2 * C;
  column_sums_finish<<<(total + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, out, N, T, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dx (N, D, H, W, Ci) from gy (N, Do, Ho, Wo, Co), with CORR (y, gs) and
// POST (x, pre; dst (N, 2, Ci) [sum du*x; sum du], part (N, classes, nb, 2,
// Ci) scratch; classes = 8 at stride 2, else 1). bn by Ci as the forward's
// by Co.
extern "C" int conv3d_k3_f32_dx_launch(const void* gy, const void* w,
                                       const void* y, const void* gs,
                                       const void* x, const void* pre,
                                       void* dx, void* dst, void* part, int N,
                                       int D, int H, int W, int Ci, int Co,
                                       int stride, int bn, int nb, float slope,
                                       void* stream) {
  if ((stride != 1 && stride != 2) || Co % BK || !(bn == 32 || bn == 64) ||
      Ci % bn || N < 1 || !extent_ok(D, H, W) || nb < 1 ||
      (y == nullptr) != (gs == nullptr) ||
      (pre == nullptr) != (x == nullptr) ||
      (pre == nullptr) != (dst == nullptr) ||
      (dst == nullptr) != (part == nullptr))
    return (int)cudaErrorInvalidValue;
  DxArgs a;
  a.gy = static_cast<const float*>(gy);
  a.w = static_cast<const float*>(w);
  a.y = static_cast<const float*>(y);
  a.gs = static_cast<const float*>(gs);
  a.x = static_cast<const float*>(x);
  a.pre = static_cast<const float*>(pre);
  a.dx = static_cast<float*>(dx);
  a.part = static_cast<float*>(part);
  a.g = geom(N, D, H, W, Ci, Co, stride);
  a.slope = slope;
  // the largest class's rows (parity 0 on every axis)
  const long long rows = stride == 1 ? (long long)D * H * W
                                     : (long long)((D + 1) / 2) *
                                           ((H + 1) / 2) * ((W + 1) / 2);
  a.mtiles = rows_tiles(rows, bn == 64 ? WideT::BM : NarrowT::BM);
  if (nb > a.mtiles) return (int)cudaErrorInvalidValue;
  const int classes = stride == 1 ? 1 : 8;
  const dim3 grid(nb, Ci / bn, N * classes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) {
    if (stride == 1) conv3d_k3_dx_s1_f32<WideT><<<grid, THREADS, 0, st>>>(a);
    else conv3d_k3_dx_s2_f32<WideT><<<grid, THREADS, 0, st>>>(a);
  } else {
    if (stride == 1) conv3d_k3_dx_s1_f32<NarrowT><<<grid, THREADS, 0, st>>>(a);
    else conv3d_k3_dx_s2_f32<NarrowT><<<grid, THREADS, 0, st>>>(a);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !dst) return (int)e;
  return finish_columns(a.part, static_cast<float*>(dst), N, classes * nb, Ci,
                        st);
}

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
