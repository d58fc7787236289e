// Input gradient (dx) of the 3x3x3 pad-1 convolution on NDHWC bf16 with
// fp32 accumulation, stride 1 or 2, for Hopper (sm_90a). Plain C interface,
// bound with ctypes (ops/conv3d.py conv3d_k3_dx).
//
// Replaces the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_conv_kernel in its corr/post
//     mode (via _conv3d_dx_fused_f: the backward of conv3d_packed_stats,
//     conv3d_packed_ns and conv3d_packed_dual_stats)
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_s2_dx_kernel (via
//     _conv3d_s2_dx_impl: the backward of conv3d_s2_packed)
// It computes, for the forward y[o] = sum_k x[o*S - 1 + k] . w[k],
//   dx[i, ci] = sum_{k, co} g[o, co] * w[k, ci, co],  o = (i + 1 - k) / S
// over the taps k for which o is a whole number in range: the transposed
// conv with the flipped, transposed weights, indexed in place (no w_flip is
// written). Fusions kept from the TPU kernel:
//   CORR  g = gy + gs[0] + 2*y*gs[1] (the instance-norm stats' cotangent
//         folded into the output's), built in fp32 as each value is staged;
//         an out-of-range o stages 0, so the +gs[0] term never reaches the
//         zero padding (pallas_conv.py _tile_corr_flat). The corrected
//         cotangent is never written to device memory.
//   POST  the backward of the pre-op leaky(x*scale - shift): with the raw
//         input x and pre = [scale; shift], u = x*scale - shift,
//         du = dx_n * (u >= 0 ? 1 : slope); the kernel writes du*scale, and
//         each block stores its [sum du*x; sum du] over its voxels (warps
//         added in order) to its own 64-float slot of an fp32 scratch;
//         conv3d_k3_dx_dst_sum adds the slots of each (sample, channel) in
//         a fixed order into (N, 2, Ci). No atomics: two runs give bit-equal
//         dx and [sum du*x; sum du].
//
// Design: the forward kernel's direct conv with the roles of input and
// output swapped. A block of 256 threads owns 128 dx voxels of one sample
// and 32 dx channels; each thread owns a 4 voxel x 4 channel register tile.
// For each tap and each 32-channel chunk of Co the block stages the
// (corrected) cotangent and the tap's transposed weights in shared memory as
// fp32 and runs 32 x 16 FMAs per thread out of it. At stride 2 a voxel i
// receives a tap k only where i + 1 - k is even; so each block takes the
// voxels of one parity class (i mod 2 on each axis), whose taps are the
// same for all of them: 1, 2, 4 or 8 taps, never the 27 with 7/8 masked.
//
// What bounds it on the H100: the fp32 FMA pipes (67 TFLOP/s published
// peak), as in the forward: 2*27*Co FLOPs per dx value at stride 1 against
// a few bytes of traffic. The tensor cores are unused; an implicit-GEMM
// wgmma version is later work.
//
// Requirements (checked by the wrapper): Ci % 32 == 0, Co % 32 == 0,
// contiguous tensors, 16-byte aligned gy, y and x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TV = 128;       // dx voxels per block
constexpr int CIB = 32;       // dx channels per block
constexpr int CK = 32;        // cotangent channels per staged chunk
constexpr int VPT = 4;        // voxels per thread
constexpr int CPT = 4;        // dx channels per thread
constexpr int THREADS = 256;  // (TV / VPT) x (CIB / CPT) = 32 x 8
constexpr int WARPS = THREADS / 32;
constexpr int SLOT = 2 * CIB;  // POST: floats of a block's [sum; sum] slot
constexpr int SUM_THREADS = 1024;

__device__ __forceinline__ void unpack8(const uint4& q, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack4(const uint2& q, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
  float2 a = __bfloat1622float2(p[0]);
  float2 b = __bfloat1622float2(p[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ uint2 pack4(const float* v) {
  uint2 q;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&q);
  p[0] = __floats2bfloat162_rn(v[0], v[1]);
  p[1] = __floats2bfloat162_rn(v[2], v[3]);
  return q;
}

// taps on one axis for a voxel of parity p: all 3 at stride 1; at stride 2
// k = 1 for even i, k in {0, 2} for odd i
template <int STRIDE>
__device__ __forceinline__ int axis_taps(int p) {
  return STRIDE == 1 ? 3 : (p ? 2 : 1);
}

template <int STRIDE>
__device__ __forceinline__ int axis_k(int p, int t) {
  return STRIDE == 1 ? t : (p ? 2 * t : 1);
}

template <int STRIDE, bool CORR, bool POST>
__global__ void __launch_bounds__(THREADS)
conv3d_k3_dx_ndhwc(const __nv_bfloat16* __restrict__ gy,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ gs,
                   const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ pre,
                   __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ part,
                   int D, int H, int W, int Ci,
                   int Do, int Ho, int Wo, int Co, float slope) {
  __shared__ __align__(16) float gsm[CK][TV];
  __shared__ __align__(16) float ws[CK][CIB];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int nci = Ci / CIB;
  const int ci0 = (blockIdx.z % nci) * CIB;
  const int par = blockIdx.z / nci;  // parity class; 0 at stride 1
  const int pd = (par >> 2) & 1, ph = (par >> 1) & 1, pw = par & 1;
  // the class's voxels are i = STRIDE * j + p on each axis
  const int Dq = (D - pd + STRIDE - 1) / STRIDE;
  const int Hq = (H - ph + STRIDE - 1) / STRIDE;
  const int Wq = (W - pw + STRIDE - 1) / STRIDE;
  const int Mq = Dq * Hq * Wq;
  const int m0 = blockIdx.x * TV;
  // POST: this block's slot, (((n * nci + ci tile) * classes + parity) *
  // gridDim.x + blockIdx.x) * SLOT
  float* slot = POST ? part + ((((size_t)n * nci + blockIdx.z % nci) *
                                    (gridDim.z / nci) + par) * gridDim.x +
                                   blockIdx.x) * SLOT
                     : nullptr;
  if (m0 >= Mq) {  // uniform over the block
    if (POST && tid < SLOT) slot[tid] = 0.f;
    return;
  }

  // staging role: one dx voxel, 16 of the chunk's 32 cotangent channels
  const int sv = tid >> 1;
  const int sc = (tid & 1) * 16;
  const int sm = m0 + sv;
  const bool svalid = sm < Mq;
  int id = 0, ih = 0, iw = 0;
  if (svalid) {
    iw = (sm % Wq) * STRIDE + pw;
    const int t = sm / Wq;
    ih = (t % Hq) * STRIDE + ph;
    id = (t / Hq) * STRIDE + pd;
  }
  // weight staging role: one dx channel, 4 cotangent channels
  const int wr = tid >> 3;
  const int wc = (tid & 7) * 4;
  // compute role: 4 voxels x 4 dx channels
  const int tx = tid & 7;
  const int ty = tid >> 3;

  float acc[VPT][CPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const float* gs_n = CORR ? gs + (size_t)n * 2 * Co : nullptr;
  const int td = axis_taps<STRIDE>(pd), th = axis_taps<STRIDE>(ph),
            tw = axis_taps<STRIDE>(pw);

  for (int t = 0; t < td * th * tw; ++t) {
    const int kd = axis_k<STRIDE>(pd, t / (th * tw));
    const int kh = axis_k<STRIDE>(ph, (t / tw) % th);
    const int kw = axis_k<STRIDE>(pw, t % tw);
    const int tap = (kd * 3 + kh) * 3 + kw;
    // i = o*S - 1 + k; at stride 2 the parity class makes i + 1 - k even
    const int ad = id + 1 - kd, ah = ih + 1 - kh, aw = iw + 1 - kw;
    const int od = ad / STRIDE, oh = ah / STRIDE, ow = aw / STRIDE;
    const bool inb = svalid && ad >= 0 && ah >= 0 && aw >= 0 && od < Do &&
                     oh < Ho && ow < Wo;
    const size_t g_off =
        inb ? ((((size_t)n * Do + od) * Ho + oh) * Wo + ow) * Co : 0;

    for (int c0 = 0; c0 < Co; c0 += CK) {
      float v[16];
      if (inb) {
        const uint4* src = reinterpret_cast<const uint4*>(gy + g_off + c0 + sc);
        unpack8(src[0], v);
        unpack8(src[1], v + 8);
        if (CORR) {
          float yv[16];
          const uint4* ysrc =
              reinterpret_cast<const uint4*>(y + g_off + c0 + sc);
          unpack8(ysrc[0], yv);
          unpack8(ysrc[1], yv + 8);
#pragma unroll
          for (int j = 0; j < 16; ++j)
            v[j] += gs_n[c0 + sc + j] + 2.f * yv[j] * gs_n[Co + c0 + sc + j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) gsm[sc + j][sv] = v[j];

      {
        // w[tap, ci0 + wr, c0 + wc .. +4], stored transposed
        const uint2 q = *reinterpret_cast<const uint2*>(
            w + ((size_t)tap * Ci + ci0 + wr) * Co + c0 + wc);
        float wv[4];
        unpack4(q, wv);
#pragma unroll
        for (int j = 0; j < 4; ++j) ws[wc + j][wr] = wv[j];
      }
      __syncthreads();

#pragma unroll 8
      for (int k = 0; k < CK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&gsm[k][ty * VPT]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * CPT]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < VPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float s[CPT], q[CPT], scale[CPT], shift[CPT];
  const int ci = ci0 + tx * CPT;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
    if (POST) {
      scale[j] = pre[(size_t)n * 2 * Ci + ci + j];
      shift[j] = pre[((size_t)n * 2 + 1) * Ci + ci + j];
    }
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int m = m0 + ty * VPT + i;
    if (m < Mq) {
      const int jw = m % Wq;
      const int t = m / Wq;
      const int vd = (t / Hq) * STRIDE + pd;
      const int vh = (t % Hq) * STRIDE + ph;
      const int vw = jw * STRIDE + pw;
      const size_t off =
          ((((size_t)n * D + vd) * H + vh) * W + vw) * Ci + ci;
      float r[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) r[j] = acc[i][j];
      if (POST) {
        float xv[4];
        unpack4(*reinterpret_cast<const uint2*>(x + off), xv);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float u = xv[j] * scale[j] - shift[j];
          const float du = u >= 0.f ? r[j] : r[j] * slope;
          s[j] += du * xv[j];
          q[j] += du;
          r[j] = du * scale[j];
        }
      }
      *reinterpret_cast<uint2*>(dx + off) = pack4(r);
    }
  }

  if (POST) {
    // lanes l, l ^ 8, l ^ 16, l ^ 24 hold the same channels
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 8);
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], 8);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], 16);
    }
    __shared__ float red[2][WARPS][CIB];
    const int warp = tid >> 5;
    const int lane = tid & 31;
    if (lane < 8) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        red[0][warp][lane * CPT + j] = s[j];
        red[1][warp][lane * CPT + j] = q[j];
      }
    }
    __syncthreads();
    if (tid < SLOT) {
      const int which = tid / CIB;
      const int c = tid % CIB;
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) t += red[which][k][c];
      slot[tid] = t;
    }
  }
}

// dst[n, which, tile * 32 + c] = the sum over the rows r (parity class,
// block) of group (n, tile) of part[(group * rows + r) * 64 + which * 32 +
// c]: one block per group, each thread summing every 16th row of one
// column in order, then the 16 partial sums in order
__global__ void __launch_bounds__(SUM_THREADS)
conv3d_k3_dx_dst_sum(const float* __restrict__ part, float* __restrict__ dst,
                     int nci, long long rows, int Ci) {
  constexpr int GROUPS = SUM_THREADS / SLOT;
  __shared__ float red[GROUPS][SLOT];
  const int n = blockIdx.x / nci, tile = blockIdx.x % nci;
  const int col = threadIdx.x % SLOT, grp = threadIdx.x / SLOT;
  const float* p = part + (size_t)blockIdx.x * rows * SLOT + col;
  float s = 0.f;
  for (long long r = grp; r < rows; r += GROUPS) s += p[r * SLOT];
  red[grp][col] = s;
  __syncthreads();
  if (threadIdx.x < SLOT) {
    float t = 0.f;
    for (int k = 0; k < GROUPS; ++k) t += red[k][col];
    dst[((size_t)n * 2 + col / CIB) * Ci + tile * CIB + col % CIB] = t;
  }
}

template <int S, bool C, bool P>
void launch(dim3 grid, cudaStream_t stream, const void* gy, const void* w,
            const void* y, const void* gs, const void* x, const void* pre,
            void* dx, void* part, int D, int H, int W, int Ci, int Do, int Ho,
            int Wo, int Co, float slope) {
  conv3d_k3_dx_ndhwc<S, C, P><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(gy),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(gs),
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(pre),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part), D, H, W, Ci,
      Do, Ho, Wo, Co, slope);
}

template <int S>
void launch_stride(int key, dim3 grid, cudaStream_t st, const void* gy,
                   const void* w, const void* y, const void* gs, const void* x,
                   const void* pre, void* dx, void* part, int D, int H, int W,
                   int Ci, int Do, int Ho, int Wo, int Co, float slope) {
#define MT3D_CASE(K, C, P)                                                   \
  case K:                                                                    \
    launch<S, C, P>(grid, st, gy, w, y, gs, x, pre, dx, part, D, H, W, Ci, Do, \
                    Ho, Wo, Co, slope);                                      \
    break;
  switch (key) {
    MT3D_CASE(0, false, false)
    MT3D_CASE(1, true, false)
    MT3D_CASE(2, false, true)
    MT3D_CASE(3, true, true)
  }
#undef MT3D_CASE
}

}  // namespace

// Launches dx = conv_backward_input(gy, w) on `stream`. y and gs (the
// correction) come together or are both null; x, pre, dst (N, 2, Ci; written,
// not added to) and part (the pre-op backward) likewise. part is an fp32
// scratch of N x (Ci / 32) x classes (8 at stride 2, else 1) x blocks x 64
// floats, blocks = ceil(voxels of the largest parity class / 128)
// (ops/conv3d.py _dx_slots). Returns the cudaGetLastError() code of the
// launches (0 on success).
extern "C" int conv3d_k3_dx_ndhwc_launch(const void* gy, const void* w,
                                         const void* y, const void* gs,
                                         const void* x, const void* pre,
                                         void* dx, void* dst, void* part,
                                         int N, int D,
                                         int H, int W, int Ci, int Co,
                                         int stride, float slope,
                                         void* stream) {
  if ((stride != 1 && stride != 2) || Ci % CIB != 0 || Co % CK != 0 ||
      N < 1 || N > 65535 || (!y) != (!gs) || (!pre) != (!x) ||
      (!pre) != (!dst) || (!pre) != (!part))
    return (int)cudaErrorInvalidValue;
  const int Do = (D - 1) / stride + 1;
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  // the largest parity class at stride 2 has ceil(D/2) x ceil(H/2) x ceil(W/2)
  const int Mq = ((D + stride - 1) / stride) * ((H + stride - 1) / stride) *
                 ((W + stride - 1) / stride);
  const int classes = stride == 2 ? 8 : 1;
  const dim3 grid((Mq + TV - 1) / TV, N, (Ci / CIB) * classes);
  const int key = (pre ? 2 : 0) | (y ? 1 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stride == 1)
    launch_stride<1>(key, grid, st, gy, w, y, gs, x, pre, dx, part, D, H, W,
                     Ci, Do, Ho, Wo, Co, slope);
  else
    launch_stride<2>(key, grid, st, gy, w, y, gs, x, pre, dx, part, D, H, W,
                     Ci, Do, Ho, Wo, Co, slope);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !pre) return (int)e;
  conv3d_k3_dx_dst_sum<<<N * (Ci / CIB), SUM_THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dst), Ci / CIB,
      (long long)classes * grid.x, Ci);
  return (int)cudaGetLastError();
}
