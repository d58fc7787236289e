// Weight gradient (dW) of the 3x3x3 pad-1 convolution on NDHWC bf16 with
// fp32 accumulation, for Hopper (sm_90a). Plain C interface, bound with
// ctypes (ops/conv3d.py conv3d_k3_dw). Only its stride-2 instantiation is
// launched: stride 1 runs on the tensor cores in conv3d_k3_dw_s1.cu. The
// template keeps the stride as a parameter, as the notes below describe.
//
// Replaces the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_dw_kernel (via
//     conv3d_dw_packed: the weight gradient of every stride-1 packed conv)
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_s2_dw_kernel (via
//     _conv3d_s2_dw_impl: the weight gradient of conv3d_s2_packed)
// without their banded-weight layout. It computes
//   dW[k, ci, co] = sum_{n, o} xin[n, o*S - 1 + k, ci] * g[n, o, co]
// in fp32 over all samples and output voxels, with the TPU kernel's
// in-kernel fusions:
//   PRE   xin = leaky(x*scale - shift), the producer's norm applied as the
//         input is staged; the zero padding stays zero after it;
//   CORR  g = gy + gs[0] + 2*y*gs[1], built in fp32 as gy is staged.
//
// Design: a split-K GEMM per tap. The output (27, Ci, Co) is cut into
// (tap, 32 input channels, 32 output channels) tiles, one tile per
// blockIdx.y; the reduction over N*Do*Ho*Wo voxels (4.2 M for the flagship's
// 128^3 convs at batch 2) is cut into blockIdx.x spans of whole 128-voxel
// chunks. A block of 256 threads stages a chunk of input rows and cotangent
// rows in shared memory as fp32; four groups of 64 threads each take 32 of
// the chunk's voxels into their own 4 x 4 register tile of the 32 x 32
// output tile. At the end the four groups are summed in shared memory and
// the block adds its partial tile to a zeroed fp32 (27, Ci, Co) buffer with
// atomicAdd.
//
// Cost of the atomics: one atomicAdd per output value and span. The
// launcher picks the number of spans so that about 2048 blocks run (at
// least one chunk each): at 32->32 @128^3, N=2, that is 76 spans and
// 76 * 27 * 1024 = 2.1 M atomics onto 27,648 addresses, against 232
// GFLOP of FMAs; the atomics are a small part of the time. Their order
// changes from run to run, so the low bits of dW do too.
//
// What bounds it on the H100: the fp32 FMA pipes (67 TFLOP/s published
// peak) and the shared-memory loads feeding them (two 16-byte loads per 16
// FMAs, as in the forward). The input and cotangent are read once per tap
// and channel tile, 27 * (Ci/32) * (Co/32) times in all: from L2 for the
// most part; at 32->32 @128^3 that is 27 reads of 0.5 GB. The tensor
// cores are unused; a wgmma version is later work.
//
// Requirements (checked by the wrapper): Ci % 32 == 0, Co % 32 == 0,
// contiguous tensors, 16-byte aligned x, gy and y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TV = 128;       // voxels per staged chunk
constexpr int CB = 32;        // input and output channels per tile
constexpr int LD = CB + 4;    // padded staged row (floats), 16-byte aligned
constexpr int THREADS = 256;  // 4 groups of 64 threads (8 x 8 of 4 x 4)
constexpr int GROUP_V = TV / 4;
constexpr int TARGET_BLOCKS = 2048;

__device__ __forceinline__ void unpack8(const uint4& q, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4* src = reinterpret_cast<const uint4*>(p);
  unpack8(src[0], v);
  unpack8(src[1], v + 8);
}

__device__ __forceinline__ void store16(float* dst, const float* v) {
#pragma unroll
  for (int j = 0; j < 16; j += 4)
    *reinterpret_cast<float4*>(dst + j) =
        make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}

template <int STRIDE, bool PRE, bool CORR>
__global__ void __launch_bounds__(THREADS)
conv3d_k3_dw_ndhwc(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ gy,
                   const float* __restrict__ pre,
                   const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ gs, float* __restrict__ dw,
                   int D, int H, int W, int Ci, int Do, int Ho, int Wo,
                   int Co, long long M, long long span, float slope) {
  __shared__ __align__(16) float xs[TV][LD];
  __shared__ __align__(16) float gsm[TV][LD];

  const int tid = threadIdx.x;
  const int nco = Co / CB, nci = Ci / CB;
  const int co0 = (blockIdx.y % nco) * CB;
  const int ci0 = ((blockIdx.y / nco) % nci) * CB;
  const int tap = blockIdx.y / (nco * nci);
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const long long v_begin = (long long)blockIdx.x * span;
  const long long v_end = v_begin + span < M ? v_begin + span : M;
  const int Mo = Do * Ho * Wo;

  // staging role: one voxel, 16 of the tile's 32 channels
  const int sv = tid >> 1;
  const int sc = (tid & 1) * 16;
  // compute role: group grp takes chunk voxels [grp*32, grp*32 + 32)
  const int grp = tid >> 6;
  const int tx = tid & 7;          // output channels tx*4 .. +4
  const int ty = (tid >> 3) & 7;   // input channels ty*4 .. +4

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long v0 = v_begin; v0 < v_end; v0 += TV) {
    const long long vm = v0 + sv;
    float a[16], g[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      a[j] = 0.f;
      g[j] = 0.f;
    }
    if (vm < v_end) {
      const int n = (int)(vm / Mo);
      const int r = (int)(vm % Mo);
      const int ow = r % Wo, oh = (r / Wo) % Ho, od = r / (Wo * Ho);
      load16(gy + vm * Co + co0 + sc, g);
      if (CORR) {
        float yv[16];
        load16(y + vm * Co + co0 + sc, yv);
        const float* gs_n = gs + (size_t)n * 2 * Co + co0 + sc;
#pragma unroll
        for (int j = 0; j < 16; ++j) g[j] += gs_n[j] + 2.f * yv[j] * gs_n[Co + j];
      }
      const int id = od * STRIDE - 1 + kd, ih = oh * STRIDE - 1 + kh,
                iw = ow * STRIDE - 1 + kw;
      if (id >= 0 && id < D && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        load16(x + ((((size_t)n * D + id) * H + ih) * W + iw) * Ci + ci0 + sc,
               a);
        if (PRE) {
          const float* pre_n = pre + (size_t)n * 2 * Ci + ci0 + sc;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float u = a[j] * pre_n[j] - pre_n[Ci + j];
            a[j] = u >= 0.f ? u : u * slope;
          }
        }
      }
    }
    store16(&xs[sv][sc], a);
    store16(&gsm[sv][sc], g);
    __syncthreads();

#pragma unroll 8
    for (int k = grp * GROUP_V; k < (grp + 1) * GROUP_V; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 q = *reinterpret_cast<const float4*>(&gsm[k][tx * 4]);
      const float av[4] = {p.x, p.y, p.z, p.w};
      const float bv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // sum the four groups' tiles in shared memory (xs is free now)
  float* red = &xs[0][0];  // [4][CB][CB], 16 KB of xs's 18 KB
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(grp * CB + ty * 4 + i) * CB + tx * 4 + j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < CB * CB; e += THREADS) {
    const float t = red[e] + red[CB * CB + e] + red[2 * CB * CB + e] +
                    red[3 * CB * CB + e];
    atomicAdd(dw + ((size_t)tap * Ci + ci0 + e / CB) * Co + co0 + e % CB, t);
  }
}

template <int S, bool P, bool C>
void launch(dim3 grid, cudaStream_t stream, const void* x, const void* gy,
            const void* pre, const void* y, const void* gs, void* dw, int D,
            int H, int W, int Ci, int Do, int Ho, int Wo, int Co, long long M,
            long long span, float slope) {
  conv3d_k3_dw_ndhwc<S, P, C><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gy), static_cast<const float*>(pre),
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(gs),
      static_cast<float*>(dw), D, H, W, Ci, Do, Ho, Wo, Co, M, span, slope);
}

template <int S>
void launch_stride(int key, dim3 grid, cudaStream_t st, const void* x,
                   const void* gy, const void* pre, const void* y,
                   const void* gs, void* dw, int D, int H, int W, int Ci,
                   int Do, int Ho, int Wo, int Co, long long M,
                   long long span, float slope) {
#define MT3D_CASE(K, P, C)                                                  \
  case K:                                                                   \
    launch<S, P, C>(grid, st, x, gy, pre, y, gs, dw, D, H, W, Ci, Do, Ho, Wo, \
                    Co, M, span, slope);                                    \
    break;
  switch (key) {
    MT3D_CASE(0, false, false)
    MT3D_CASE(1, false, true)
    MT3D_CASE(2, true, false)
    MT3D_CASE(3, true, true)
  }
#undef MT3D_CASE
}

}  // namespace

// Launches dw += conv_backward_weight(x, gy) at stride 2 on `stream` into a (27, Ci, Co)
// fp32 buffer the caller has zeroed. pre may be null; y and gs (the
// correction) come together or are both null. Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int conv3d_k3_dw_ndhwc_launch(const void* x, const void* gy,
                                         const void* pre, const void* y,
                                         const void* gs, void* dw, int N,
                                         int D, int H, int W, int Ci, int Co,
                                         int stride, float slope,
                                         void* stream) {
  if (stride != 2 || Ci % CB != 0 || Co % CB != 0 ||
      N < 1 || (!y) != (!gs))
    return (int)cudaErrorInvalidValue;
  const int Do = (D - 1) / stride + 1;
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const long long M = (long long)N * Do * Ho * Wo;
  const int tiles = 27 * (Ci / CB) * (Co / CB);
  const long long chunks = (M + TV - 1) / TV;
  long long splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  if (splits > chunks) splits = chunks;
  const long long span = ((chunks + splits - 1) / splits) * TV;
  const dim3 grid((unsigned)((M + span - 1) / span), tiles);
  const int key = (pre ? 2 : 0) | (y ? 1 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_stride<2>(key, grid, st, x, gy, pre, y, gs, dw, D, H, W, Ci, Do, Ho,
                   Wo, Co, M, span, slope);
  return (int)cudaGetLastError();
}
