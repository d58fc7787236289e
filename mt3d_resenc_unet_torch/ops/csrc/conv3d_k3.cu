// 3x3x3 pad-1 convolution on NDHWC bf16 with fp32 accumulation, for Hopper
// (sm_90a). Plain C interface, bound with ctypes (ops/conv3d.py). Only its
// stride-2 instantiation is launched: stride 1 runs on the tensor cores in
// conv3d_k3_s1.cu. The template keeps the stride as a parameter, as the
// notes below describe.
//
// Replaces the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_conv_kernel (stride 1, via
//     _conv3d_banded_packed_f: conv3d_packed / _stats / _ns / _dual_stats)
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_s2_fwd_kernel (stride 2, via
//     _conv3d_s2_packed_impl: conv3d_s2)
// without their TPU layout: no x-packing into 128 lanes and no banded
// weights. It keeps their fusions:
//   PRE   the producer's instance norm + LeakyReLU, leaky(x*scale - shift),
//         applied to each input value as it is staged; padding stays zero
//         AFTER the pre-op (pallas_conv.py _tile_norm);
//   STATS fp32 [sum; sumsq] of the output per (sample, channel), taken from
//         the fp32 accumulator, reduced in the block and added to a zeroed
//         (N, 2, Co) buffer with atomicAdd;
//   ADDIN a second conv's bf16 output added to the accumulator before the
//         stats (the decoder's split-weight skip concat,
//         conv3d_packed_dual_stats).
//
// Design: a direct conv. A block of 256 threads owns 128 consecutive
// output voxels of one sample and 32 output channels; each thread owns a
// 4 voxel x 4 channel register tile. For each of the 27 taps and each
// 32-channel input chunk, the block stages the (pre-op'd, zero-padded)
// input values and the tap's weights in shared memory as fp32, then runs
// 32 x 16 FMAs per thread out of shared memory.
//
// What bounds it on the H100: the fp32 FMA pipes (67 TFLOP/s published
// peak), not memory. Every flagship shape does 2*27*Ci FLOPs per output
// value against a few bytes of traffic, far above the card's ~295 FLOP/byte
// balance point. The tensor cores (989 TFLOP/s in bf16) are unused: an
// implicit-GEMM wgmma version is later work.
//
// Requirements (checked by the wrapper): Ci % 32 == 0, Co % 32 == 0,
// contiguous tensors, 16-byte aligned x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TV = 128;       // output voxels per block
constexpr int COB = 32;       // output channels per block
constexpr int CK = 32;        // input channels per staged chunk
constexpr int VPT = 4;        // voxels per thread
constexpr int CPT = 4;        // output channels per thread
constexpr int THREADS = 256;  // (TV / VPT) x (COB / CPT) = 32 x 8
constexpr int WARPS = THREADS / 32;

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

template <int STRIDE, bool PRE, bool STATS, bool ADDIN>
__global__ void __launch_bounds__(THREADS)
conv3d_k3_ndhwc(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ pre,
                const __nv_bfloat16* __restrict__ add_to,
                __nv_bfloat16* __restrict__ y,
                float* __restrict__ stats,
                int D, int H, int W, int Ci,
                int Do, int Ho, int Wo, int Co, float slope) {
  __shared__ __align__(16) float xs[CK][TV];
  __shared__ __align__(16) float ws[CK][COB];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int co0 = blockIdx.z * COB;
  const int m0 = blockIdx.x * TV;
  const int Mo = Do * Ho * Wo;

  // staging role: one output voxel, 16 of the chunk's 32 input channels
  const int sv = tid >> 1;
  const int sc = (tid & 1) * 16;
  const int sm = m0 + sv;
  const bool svalid = sm < Mo;
  int od = 0, oh = 0, ow = 0;
  if (svalid) {
    ow = sm % Wo;
    const int t = sm / Wo;
    oh = t % Ho;
    od = t / Ho;
  }
  // weight staging role: one input channel row, 4 output channels
  const int wr = tid >> 3;
  const int wc = (tid & 7) * 4;

  // compute role: 4 voxels x 4 output channels
  const int tx = tid & 7;
  const int ty = tid >> 3;

  float acc[VPT][CPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const size_t x_n = (size_t)n * D * H * W * Ci;
  const float* pre_n = PRE ? pre + (size_t)n * 2 * Ci : nullptr;

  for (int tap = 0; tap < 27; ++tap) {
    const int kd = tap / 9;
    const int kh = (tap / 3) % 3;
    const int kw = tap % 3;
    const int id = od * STRIDE - 1 + kd;
    const int ih = oh * STRIDE - 1 + kh;
    const int iw = ow * STRIDE - 1 + kw;
    const bool inb = svalid && id >= 0 && id < D && ih >= 0 && ih < H &&
                     iw >= 0 && iw < W;
    const size_t x_off = inb ? x_n + (((size_t)id * H + ih) * W + iw) * Ci : 0;

    for (int c0 = 0; c0 < Ci; c0 += CK) {
      float v[16];
      if (inb) {
        const uint4* src = reinterpret_cast<const uint4*>(x + x_off + c0 + sc);
        unpack8(src[0], v);
        unpack8(src[1], v + 8);
        if (PRE) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float u = v[j] * pre_n[c0 + sc + j] - pre_n[Ci + c0 + sc + j];
            v[j] = u >= 0.f ? u : u * slope;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) xs[sc + j][sv] = v[j];

      {
        const uint2 q = *reinterpret_cast<const uint2*>(
            w + ((size_t)tap * Ci + c0 + wr) * Co + co0 + wc);
        float wv[4];
        unpack4(q, wv);
        *reinterpret_cast<float4*>(&ws[wr][wc]) =
            make_float4(wv[0], wv[1], wv[2], wv[3]);
      }
      __syncthreads();

#pragma unroll 8
      for (int k = 0; k < CK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * VPT]);
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

  float s[CPT], q[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
  }
  const int co = co0 + tx * CPT;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int m = m0 + ty * VPT + i;
    if (m < Mo) {
      const size_t off = ((size_t)n * Mo + m) * Co + co;
      float r[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) r[j] = acc[i][j];
      if (ADDIN) {
        float a[4];
        unpack4(*reinterpret_cast<const uint2*>(add_to + off), a);
#pragma unroll
        for (int j = 0; j < CPT; ++j) r[j] += a[j];
      }
      if (STATS) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[j] += r[j];
          q[j] += r[j] * r[j];
        }
      }
      *reinterpret_cast<uint2*>(y + off) = pack4(r);
    }
  }

  if (STATS) {
    // lanes l and l ^ 8, l ^ 16 hold the same channels for other voxels
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 8);
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], 8);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], 16);
    }
    __shared__ float red[2][WARPS][COB];
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
    if (tid < 2 * COB) {
      const int which = tid / COB;
      const int c = tid % COB;
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) t += red[which][k][c];
      atomicAdd(stats + ((size_t)n * 2 + which) * Co + co0 + c, t);
    }
  }
}

template <int S, bool P, bool ST, bool A>
void launch(dim3 grid, cudaStream_t stream, const void* x, const void* w,
            const void* pre, const void* add_to, void* y, void* stats, int D,
            int H, int W, int Ci, int Do, int Ho, int Wo, int Co,
            float slope) {
  conv3d_k3_ndhwc<S, P, ST, A><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(pre),
      static_cast<const __nv_bfloat16*>(add_to),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(stats), D, H, W, Ci,
      Do, Ho, Wo, Co, slope);
}

template <int S>
void launch_stride(int key, dim3 grid, cudaStream_t st, const void* x,
                   const void* w, const void* pre, const void* add_to, void* y,
                   void* stats, int D, int H, int W, int Ci, int Do, int Ho,
                   int Wo, int Co, float slope) {
#define MT3D_CASE(K, P, STT, A)                                             \
  case K:                                                                   \
    launch<S, P, STT, A>(grid, st, x, w, pre, add_to, y, stats, D, H, W, Ci, \
                         Do, Ho, Wo, Co, slope);                            \
    break;
  switch (key) {
    MT3D_CASE(0, false, false, false)
    MT3D_CASE(1, false, false, true)
    MT3D_CASE(2, false, true, false)
    MT3D_CASE(3, false, true, true)
    MT3D_CASE(4, true, false, false)
    MT3D_CASE(5, true, false, true)
    MT3D_CASE(6, true, true, false)
    MT3D_CASE(7, true, true, true)
  }
#undef MT3D_CASE
}

}  // namespace

// Launches y = conv(x, w) at stride 2 on `stream`. pre / add_to / stats may be null
// when their mode is off; stats must be zeroed by the caller. Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int conv3d_k3_ndhwc_launch(const void* x, const void* w,
                                      const void* pre, const void* add_to,
                                      void* y, void* stats, int N, int D,
                                      int H, int W, int Ci, int Co, int stride,
                                      float slope, void* stream) {
  if (stride != 2 || Ci % CK != 0 || Co % COB != 0 ||
      N < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const int Do = (D - 1) / stride + 1;
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const int Mo = Do * Ho * Wo;
  const dim3 grid((Mo + TV - 1) / TV, N, Co / COB);
  const int key = (pre ? 4 : 0) | (stats ? 2 : 0) | (add_to ? 1 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_stride<2>(key, grid, st, x, w, pre, add_to, y, stats, D, H, W, Ci,
                   Do, Ho, Wo, Co, slope);
  return (int)cudaGetLastError();
}
