// Backward of the 2x2x2 stride-2 transposed convolution (kernel == stride)
// on NDHWC bf16 with fp32 accumulation, for Hopper (sm_90a). Plain C
// interface, bound with ctypes (ops/upsample.py upsample2x_dx and
// upsample2x_dw).
//
// Replaces the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_upsample.py::_dx_kernel and ::_dw_kernel
//   (the backward of upsample2x_packed, _upsample_bwd)
// without their lane packing. For the forward
//   y[n, 2i+a, 2j+b, 2k+c, :] = x[n, i, j, k, :] @ Wf[a, b, c]
// (Wf flipped by the caller) they compute, with p = (a, b, c):
//   dx[n, i, j, k, ci] = sum_{p, co} gy[n, 2i+a, 2j+b, 2k+c, co] Wf[p, ci, co]
//   dWf[p, ci, co]     = sum_{n, i, j, k} x[n, i, j, k, ci] gy[.., co]   (fp32)
// As on the TPU, the depth-to-space gather is built into the loads of gy:
// no stack or transpose pass runs before them.
//
// Design: both are GEMMs over the coarse voxels run as direct kernels with
// the layout of the forward (csrc/upsample2x.cu).
//   dx: a block of 256 threads owns 128 coarse voxels and 32 input
//       channels; each thread a 4 voxel x 4 channel register tile. The
//       reduction runs over the 8 parities x Co in staged chunks of 32
//       cotangent channels, with the weights read transposed in place.
//   dW: a split-K GEMM per parity: a block owns one (parity, 32 ci, 32 co)
//       tile and a span of whole 128-voxel chunks; four groups of 64 threads take 32 voxels of each
//       chunk; the block adds its partial tile to a zeroed fp32
//       (8, Ci, Co) buffer with atomicAdd (about 2048 blocks in all, so the
//       atomics are few beside the FMAs; their order varies from run to
//       run).
//
// What bounds it on the H100: the fp32 FMA pipes, as in the forward: for
// the flagship's 128->64 and 64->32 upsamples each dx value costs 2*8*Co
// FLOPs (1024 or 512) against 2 bytes written. The tensor cores are
// unused; a wgmma version is later work.
//
// Requirements (checked by the wrapper): Ci % 32 == 0, Co % 32 == 0,
// contiguous tensors, 16-byte aligned x and gy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TV = 128;
constexpr int CB = 32;
constexpr int LD = CB + 4;
constexpr int VPT = 4;
constexpr int CPT = 4;
constexpr int THREADS = 256;
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

// offset of gy[n, 2d+a, 2h+b, 2w+c, 0] for coarse voxel m and parity p
__device__ __forceinline__ size_t fine_offset(long long m, int p, int Di,
                                              int Hi, int Wi, int Co) {
  const int k = (int)(m % Wi);
  long long t = m / Wi;
  const int j = (int)(t % Hi);
  t /= Hi;
  const int d = (int)(t % Di);
  const long long n = t / Di;
  const int a = p >> 2, b = (p >> 1) & 1, c = p & 1;
  return ((((size_t)n * 2 * Di + 2 * d + a) * 2 * Hi + 2 * j + b) *
              (size_t)(2 * Wi) + 2 * k + c) * Co;
}

__global__ void __launch_bounds__(THREADS)
upsample2x_dx_ndhwc(const __nv_bfloat16* __restrict__ gy,
                    const __nv_bfloat16* __restrict__ wf,
                    __nv_bfloat16* __restrict__ dx, long long M, int Di,
                    int Hi, int Wi, int Ci, int Co) {
  __shared__ __align__(16) float gsm[CB][TV];
  __shared__ __align__(16) float ws[CB][CB];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * TV;
  const int ci0 = blockIdx.y * CB;

  const int sv = tid >> 1;
  const int sc = (tid & 1) * 16;
  const bool svalid = m0 + sv < M;
  const int wr = tid >> 3;
  const int wc = (tid & 7) * 4;
  const int tx = tid & 7;
  const int ty = tid >> 3;

  float acc[VPT][CPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int p = 0; p < 8; ++p) {
    const size_t g_off = svalid ? fine_offset(m0 + sv, p, Di, Hi, Wi, Co) : 0;
    for (int c0 = 0; c0 < Co; c0 += CB) {
      float v[16];
      if (svalid) {
        load16(gy + g_off + c0 + sc, v);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) gsm[sc + j][sv] = v[j];
      {
        // wf[p, ci0 + wr, c0 + wc .. +4], stored transposed
        const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(
            wf + ((size_t)p * Ci + ci0 + wr) * Co + c0 + wc);
        const float2 a = __bfloat1622float2(q[0]);
        const float2 b = __bfloat1622float2(q[1]);
        ws[wc][wr] = a.x;
        ws[wc + 1][wr] = a.y;
        ws[wc + 2][wr] = b.x;
        ws[wc + 3][wr] = b.y;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < CB; ++k) {
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

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const long long m = m0 + ty * VPT + i;
    if (m < M) {
      uint2 q;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&q);
      p[0] = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      p[1] = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
      *reinterpret_cast<uint2*>(dx + m * Ci + ci0 + tx * CPT) = q;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
upsample2x_dw_ndhwc(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ gy,
                    float* __restrict__ dw, long long M, int Di, int Hi,
                    int Wi, int Ci, int Co, long long span) {
  __shared__ __align__(16) float xs[TV][LD];
  __shared__ __align__(16) float gsm[TV][LD];

  const int tid = threadIdx.x;
  const int nco = Co / CB, nci = Ci / CB;
  const int co0 = (blockIdx.y % nco) * CB;
  const int ci0 = ((blockIdx.y / nco) % nci) * CB;
  const int p = blockIdx.y / (nco * nci);
  const long long v_begin = (long long)blockIdx.x * span;
  const long long v_end = v_begin + span < M ? v_begin + span : M;

  const int sv = tid >> 1;
  const int sc = (tid & 1) * 16;
  const int grp = tid >> 6;
  const int tx = tid & 7;
  const int ty = (tid >> 3) & 7;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long v0 = v_begin; v0 < v_end; v0 += TV) {
    const long long vm = v0 + sv;
    float a[16], g[16];
    if (vm < v_end) {
      load16(x + vm * Ci + ci0 + sc, a);
      load16(gy + fine_offset(vm, p, Di, Hi, Wi, Co) + co0 + sc, g);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        a[j] = 0.f;
        g[j] = 0.f;
      }
    }
    store16(&xs[sv][sc], a);
    store16(&gsm[sv][sc], g);
    __syncthreads();
#pragma unroll 8
    for (int k = grp * GROUP_V; k < (grp + 1) * GROUP_V; ++k) {
      const float4 s = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 q = *reinterpret_cast<const float4*>(&gsm[k][tx * 4]);
      const float av[4] = {s.x, s.y, s.z, s.w};
      const float bv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* red = &xs[0][0];  // [4][CB][CB]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(grp * CB + ty * 4 + i) * CB + tx * 4 + j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < CB * CB; e += THREADS) {
    const float t = red[e] + red[CB * CB + e] + red[2 * CB * CB + e] +
                    red[3 * CB * CB + e];
    atomicAdd(dw + ((size_t)p * Ci + ci0 + e / CB) * Co + co0 + e % CB, t);
  }
}

}  // namespace

// dx (N, Di, Hi, Wi, Ci) bf16 from gy (N, 2Di, 2Hi, 2Wi, Co) and wf
// (2, 2, 2, Ci, Co) flipped. Returns the cudaGetLastError() code.
extern "C" int upsample2x_dx_ndhwc_launch(const void* gy, const void* wf,
                                          void* dx, int N, int Di, int Hi,
                                          int Wi, int Ci, int Co,
                                          void* stream) {
  if (Ci % CB != 0 || Co % CB != 0 || N < 1) return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * Di * Hi * Wi;
  const dim3 grid((unsigned)((M + TV - 1) / TV), Ci / CB);
  upsample2x_dx_ndhwc<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gy),
      static_cast<const __nv_bfloat16*>(wf), static_cast<__nv_bfloat16*>(dx),
      M, Di, Hi, Wi, Ci, Co);
  return (int)cudaGetLastError();
}

// dw += the (8, Ci, Co) fp32 weight gradient of the flipped wf from x
// (N, Di, Hi, Wi, Ci) and gy (N, 2Di, 2Hi, 2Wi, Co); dw must be zeroed by
// the caller. Returns the cudaGetLastError() code.
extern "C" int upsample2x_dw_ndhwc_launch(const void* x, const void* gy,
                                          void* dw, int N, int Di, int Hi,
                                          int Wi, int Ci, int Co,
                                          void* stream) {
  if (Ci % CB != 0 || Co % CB != 0 || N < 1) return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * Di * Hi * Wi;
  const int tiles = 8 * (Ci / CB) * (Co / CB);
  const long long chunks = (M + TV - 1) / TV;
  long long splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  if (splits > chunks) splits = chunks;
  const long long span = ((chunks + splits - 1) / splits) * TV;
  const dim3 grid((unsigned)((M + span - 1) / span), tiles);
  upsample2x_dw_ndhwc<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gy), static_cast<float*>(dw), M, Di,
      Hi, Wi, Ci, Co, span);
  return (int)cudaGetLastError();
}
