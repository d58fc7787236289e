// 2x2x2 stride-2 transposed convolution (kernel == stride) on NDHWC bf16
// with fp32 accumulation, for Hopper (sm_90a). Plain C interface, bound
// with ctypes (ops/upsample.py).
//
// Replaces the TPU's Pallas kernel
//   mt3d_resenc_unet_tpu/ops/pallas_upsample.py::_fwd_kernel (via _run_fwd,
//   upsample2x_packed)
// without its lane packing: it computes
//   y[n, 2i+a, 2j+b, 2k+c, :] = x[n, i, j, k, :] @ Wf[a, b, c]
// where Wf is the transposed-conv kernel with its spatial flip already
// applied by the caller (models/network.py UpsampleConv). As on the TPU,
// the depth-to-space interleave is built into the output write, so no
// stack or transpose pass follows.
//
// Design: a GEMM (N*Di*Hi*Wi, Ci) x (Ci, 8*Co) run as a direct kernel. A
// block of 256 threads owns 128 input voxels and 32 output columns of one
// parity (a, b, c); each thread owns a 4 voxel x 4 channel register tile.
// Input and weight chunks of 32 channels are staged in shared memory as
// fp32.
//
// What bounds it on the H100: for the flagship's 128->64 and 64->32
// upsamples each output value costs 2*Ci FLOPs (128 or 256) against 2
// bytes written, above the fp32 FMA pipes' balance point of about 20
// FLOP/byte (67 TFLOP/s over 3.35 TB/s), so the FMA pipes bound it. On the
// tensor cores it would turn memory-bound; a wgmma tile with a TMA store
// is later work.
//
// Requirements (checked by the wrapper): Ci % 32 == 0, Co % 32 == 0,
// contiguous tensors, 16-byte aligned x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TV = 128;
constexpr int COB = 32;
constexpr int CK = 32;
constexpr int VPT = 4;
constexpr int CPT = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ void unpack8(const uint4& q, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__global__ void __launch_bounds__(THREADS)
upsample2x_ndhwc(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wf,
                 __nv_bfloat16* __restrict__ y, int N, int Di, int Hi, int Wi,
                 int Ci, int Co) {
  __shared__ __align__(16) float xs[CK][TV];
  __shared__ __align__(16) float ws[CK][COB];

  const int tid = threadIdx.x;
  const long long M = (long long)N * Di * Hi * Wi;
  const long long m0 = (long long)blockIdx.x * TV;
  const int col0 = blockIdx.y * COB;  // column in [0, 8*Co)
  const int par = col0 / Co;          // parity a*4 + b*2 + c
  const int co0 = col0 % Co;

  const int sv = tid >> 1;
  const int sc = (tid & 1) * 16;
  const bool svalid = m0 + sv < M;
  const __nv_bfloat16* xrow = x + (m0 + sv) * Ci;
  const int wr = tid >> 3;
  const int wc = (tid & 7) * 4;
  const int tx = tid & 7;
  const int ty = tid >> 3;

  float acc[VPT][CPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += CK) {
    float v[16];
    if (svalid) {
      const uint4* src = reinterpret_cast<const uint4*>(xrow + c0 + sc);
      unpack8(src[0], v);
      unpack8(src[1], v + 8);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) xs[sc + j][sv] = v[j];
    {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(
          wf + ((size_t)par * Ci + c0 + wr) * Co + co0 + wc);
      const float2 a = __bfloat1622float2(p[0]);
      const float2 b = __bfloat1622float2(p[1]);
      *reinterpret_cast<float4*>(&ws[wr][wc]) = make_float4(a.x, a.y, b.x, b.y);
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

  const int pa = par >> 2, pb = (par >> 1) & 1, pc = par & 1;
  const int Do = 2 * Di, Ho = 2 * Hi, Wo = 2 * Wi;
  const int co = co0 + tx * CPT;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const long long m = m0 + ty * VPT + i;
    if (m < M) {
      const int k = (int)(m % Wi);
      long long t = m / Wi;
      const int j = (int)(t % Hi);
      t /= Hi;
      const int d = (int)(t % Di);
      const long long n = t / Di;
      const size_t off =
          (((size_t)n * Do + 2 * d + pa) * Ho + 2 * j + pb) * (size_t)Wo * Co +
          (size_t)(2 * k + pc) * Co + co;
      uint2 q;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&q);
      p[0] = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      p[1] = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
      *reinterpret_cast<uint2*>(y + off) = q;
    }
  }
}

}  // namespace

// Launches y = upsample(x, wf) on `stream`; wf is (2, 2, 2, Ci, Co)
// already flipped. Returns the cudaGetLastError() code of the launch.
extern "C" int upsample2x_ndhwc_launch(const void* x, const void* wf, void* y,
                                       int N, int Di, int Hi, int Wi, int Ci,
                                       int Co, void* stream) {
  if (Ci % CK != 0 || Co % COB != 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * Di * Hi * Wi;
  const dim3 grid((unsigned)((M + TV - 1) / TV), 8 * Co / COB);
  upsample2x_ndhwc<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wf), static_cast<__nv_bfloat16*>(y), N,
      Di, Hi, Wi, Ci, Co);
  return (int)cudaGetLastError();
}
