// Instance norm + LeakyReLU over (N, S, C) channels-last tensors, forward
// and backward, for Hopper (sm_90a). bf16 or fp32 in, fp32 statistics.
// Plain C interface, bound with ctypes (ops/norm_act.py).
//
// Replaces the TPU's Pallas kernels of
//   mt3d_resenc_unet_tpu/ops/pallas_norm_act.py
//   _stats_kernel      -> norm_act_stats_partial + norm_act_finalize
//   _norm_kernel       -> norm_act_norm
//   _bwd_stats_kernel  -> norm_act_bwd_stats_partial + norm_act_finalize
//   _bwd_dx_kernel     -> norm_act_bwd_dx
// computing what they compute, in the same arithmetic: the statistics are
// E[x^2] - mean^2 in fp32, clamped at 0, inv = rsqrt(var + eps); the
// normalize runs in x's dtype after mean and inv are rounded to it; the
// backward rebuilds fp32 xhat from the fp32 mean and inv.
//
// Design: the channel dimension is innermost, so a warp's threads run along
// C with one 16-byte vector each (8 bf16 or 4 fp32 channels) and a block
// covers rows = 256 / (C / vec) voxels at a time. On the TPU the spatial
// grid axis runs in order and carries the sums in scratch memory; here a
// grid of (chunk, n) blocks runs in parallel, each block reduces its chunk
// of voxels to one fp32 partial per channel (through shared memory, in a
// fixed order), and norm_act_finalize adds the partials of a sample over
// the chunks in chunk order. So the sums are deterministic: no atomics, the
// same bits on every run.
//
// What bounds it on the H100: bytes. Each pass reads x (and g) once with a
// handful of fp32 operations per element; the forward moves 3 tensors'
// worth of bytes (read x twice, write y), the backward 5 (read x and g
// twice, write dx), against 3.35 TB/s of HBM. The chunking puts 1-2k blocks
// on the 132 SMs at the flagship's large shapes so that enough loads are in
// flight; the partials are a few hundred KB at most.
//
// Requirements (checked by the wrapper): contiguous tensors, 16-byte
// aligned, C a multiple of the vector width with C / vec <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// v rounded to T and back: the rounding of one operation in T's arithmetic
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// Thread and chunk geometry shared by every kernel: block (chunk, n) owns
// voxels [r0, r1) of sample n; thread tid owns vector cv of each row it
// visits, rows r0 + r, r0 + r + rows, ...
struct Geometry {
  int cols, rows, r, cv;
  long long r0, r1;
  bool active;
  __device__ Geometry(long long S, int C, int vec, long long per_chunk) {
    cols = C / vec;
    rows = THREADS / cols;
    r = threadIdx.x / cols;
    cv = threadIdx.x % cols;
    active = r < rows;
    r0 = (long long)blockIdx.x * per_chunk;
    r1 = r0 + per_chunk < S ? r0 + per_chunk : S;
  }
};

// Reduce two per-thread vectors (a, b) over the block's rows into the
// partial slots part[0:C] and part[C:2C] of this (n, chunk).
template <int VN>
__device__ __forceinline__ void block_reduce_store(const Geometry& g, int C,
                                                   const float* a,
                                                   const float* b,
                                                   float* part) {
  __shared__ float sa[THREADS * VN];
  __shared__ float sb[THREADS * VN];
  if (g.active) {
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      sa[g.r * C + g.cv * VN + j] = a[j];
      sb[g.r * C + g.cv * VN + j] = b[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float ta = 0.f, tb = 0.f;
    for (int r = 0; r < g.rows; ++r) {
      ta += sa[r * C + c];
      tb += sb[r * C + c];
    }
    part[c] = ta;
    part[C + c] = tb;
  }
}

// _stats_kernel, first half: per-chunk fp32 [sum x; sum x^2].
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_act_stats_partial(const T* __restrict__ x, float* __restrict__ part,
                       long long S, int C, long long per_chunk) {
  constexpr int VN = Vec<T>::N;
  const Geometry g(S, C, VN, per_chunk);
  const int n = blockIdx.y;
  float s[VN], q[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j) s[j] = q[j] = 0.f;
  if (g.active) {
    const T* xn = x + (size_t)n * S * C + g.cv * VN;
    for (long long i = g.r0 + g.r; i < g.r1; i += g.rows) {
      float v[VN];
      load_vec(xn + (size_t)i * C, v);
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        s[j] += v[j];
        q[j] = fmaf(v[j], v[j], q[j]);
      }
    }
  }
  block_reduce_store<VN>(g, C, s, q,
                         part + ((size_t)n * gridDim.x + blockIdx.x) * 2 * C);
}

// Sum the partials of sample blockIdx.x over its chunks, in chunk order.
// stats_mode: out = [mean; rsqrt(max(E[x^2] - mean^2, 0) + eps)] (the end
// of _stats_kernel); otherwise out = the raw sums (_bwd_stats_kernel's).
__global__ void __launch_bounds__(THREADS)
norm_act_finalize(const float* __restrict__ part, float* __restrict__ out,
                  int nchunk, int C, float inv_s, float eps, int stats_mode) {
  const int n = blockIdx.x;
  const float* pn = part + (size_t)n * nchunk * 2 * C;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < nchunk; ++k) {
      a += pn[(size_t)k * 2 * C + c];
      b += pn[(size_t)k * 2 * C + C + c];
    }
    if (stats_mode) {
      const float mean = a * inv_s;
      const float var = b * inv_s - mean * mean;
      a = mean;
      b = rsqrtf(fmaxf(var, 0.f) + eps);
    }
    out[(size_t)n * 2 * C + c] = a;
    out[(size_t)n * 2 * C + C + c] = b;
  }
}

// _norm_kernel: y = (x - mean) * inv [then LeakyReLU], every operation
// rounded to T as the TPU kernel computes in x's dtype.
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_act_norm(const T* __restrict__ x, const float* __restrict__ stats,
              T* __restrict__ y, long long S, int C, long long per_chunk,
              float slope, int act) {
  constexpr int VN = Vec<T>::N;
  const Geometry g(S, C, VN, per_chunk);
  if (!g.active) return;
  const int n = blockIdx.y;
  const T* tag = nullptr;
  const float slope_t = round_to(slope, tag);
  float mean[VN], inv[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j) {
    mean[j] = round_to(stats[(size_t)n * 2 * C + g.cv * VN + j], tag);
    inv[j] = round_to(stats[(size_t)n * 2 * C + C + g.cv * VN + j], tag);
  }
  const size_t base = (size_t)n * S * C + g.cv * VN;
  for (long long i = g.r0 + g.r; i < g.r1; i += g.rows) {
    float v[VN];
    load_vec(x + base + (size_t)i * C, v);
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      float u = round_to(round_to(v[j] - mean[j], tag) * inv[j], tag);
      if (act && !(u >= 0.f)) u = round_to(u * slope_t, tag);
      v[j] = u;
    }
    store_vec(y + base + (size_t)i * C, v);
  }
}

// fp32 xhat and the cotangent after the LeakyReLU backward, as both
// backward TPU kernels compute them
__device__ __forceinline__ void grad_in(float xv, float gv, float mean,
                                        float inv, float slope, int act,
                                        float* xhat, float* gp) {
  *xhat = (xv - mean) * inv;
  *gp = (act && !(*xhat >= 0.f)) ? gv * slope : gv;
}

// _bwd_stats_kernel, first half: per-chunk fp32 [sum g'; sum g' * xhat].
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_act_bwd_stats_partial(const T* __restrict__ x,
                           const float* __restrict__ stats,
                           const T* __restrict__ gy, float* __restrict__ part,
                           long long S, int C, long long per_chunk,
                           float slope, int act) {
  constexpr int VN = Vec<T>::N;
  const Geometry g(S, C, VN, per_chunk);
  const int n = blockIdx.y;
  float s[VN], q[VN], mean[VN], inv[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j) {
    s[j] = q[j] = 0.f;
    mean[j] = inv[j] = 0.f;
  }
  if (g.active) {
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      mean[j] = stats[(size_t)n * 2 * C + g.cv * VN + j];
      inv[j] = stats[(size_t)n * 2 * C + C + g.cv * VN + j];
    }
    const size_t base = (size_t)n * S * C + g.cv * VN;
    for (long long i = g.r0 + g.r; i < g.r1; i += g.rows) {
      float v[VN], w[VN];
      load_vec(x + base + (size_t)i * C, v);
      load_vec(gy + base + (size_t)i * C, w);
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        float xhat, gp;
        grad_in(v[j], w[j], mean[j], inv[j], slope, act, &xhat, &gp);
        s[j] += gp;
        q[j] = fmaf(gp, xhat, q[j]);
      }
    }
  }
  block_reduce_store<VN>(g, C, s, q,
                         part + ((size_t)n * gridDim.x + blockIdx.x) * 2 * C);
}

// _bwd_dx_kernel: dx = inv * (g' - mean(g') - xhat * mean(g' xhat)).
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_act_bwd_dx(const T* __restrict__ x, const float* __restrict__ stats,
                const float* __restrict__ gsums, const T* __restrict__ gy,
                T* __restrict__ dx, long long S, int C, long long per_chunk,
                float slope, int act, float inv_s) {
  constexpr int VN = Vec<T>::N;
  const Geometry g(S, C, VN, per_chunk);
  if (!g.active) return;
  const int n = blockIdx.y;
  float mean[VN], inv[VN], mg[VN], mgx[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j) {
    const size_t c = (size_t)n * 2 * C + g.cv * VN + j;
    mean[j] = stats[c];
    inv[j] = stats[c + C];
    mg[j] = gsums[c] * inv_s;
    mgx[j] = gsums[c + C] * inv_s;
  }
  const size_t base = (size_t)n * S * C + g.cv * VN;
  for (long long i = g.r0 + g.r; i < g.r1; i += g.rows) {
    float v[VN], w[VN];
    load_vec(x + base + (size_t)i * C, v);
    load_vec(gy + base + (size_t)i * C, w);
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      float xhat, gp;
      grad_in(v[j], w[j], mean[j], inv[j], slope, act, &xhat, &gp);
      v[j] = inv[j] * (gp - mg[j] - xhat * mgx[j]);
    }
    store_vec(dx + base + (size_t)i * C, v);
  }
}

bool bad_shape(int C, int vn, int nchunk) {
  return C <= 0 || C % vn != 0 || C / vn > THREADS || nchunk < 1 ||
         nchunk > 65535;
}

long long per_chunk(long long S, int nchunk) {
  return (S + nchunk - 1) / nchunk;
}

template <typename T>
int stats_impl(const void* x, void* part, void* stats, int N, long long S,
               int C, int nchunk, float eps, cudaStream_t st) {
  if (bad_shape(C, Vec<T>::N, nchunk)) return (int)cudaErrorInvalidValue;
  norm_act_stats_partial<T><<<dim3(nchunk, N), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<float*>(part), S, C,
      per_chunk(S, nchunk));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  norm_act_finalize<<<N, THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(stats), nchunk, C,
      (float)(1.0 / (double)S), eps, 1);
  return (int)cudaGetLastError();
}

template <typename T>
int norm_impl(const void* x, const void* stats, void* y, int N, long long S,
              int C, int nchunk, float slope, int act, cudaStream_t st) {
  if (bad_shape(C, Vec<T>::N, nchunk)) return (int)cudaErrorInvalidValue;
  norm_act_norm<T><<<dim3(nchunk, N), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<T*>(y), S, C, per_chunk(S, nchunk), slope, act);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_stats_impl(const void* x, const void* stats, const void* g,
                   void* part, void* gsums, int N, long long S, int C,
                   int nchunk, float slope, int act, cudaStream_t st) {
  if (bad_shape(C, Vec<T>::N, nchunk)) return (int)cudaErrorInvalidValue;
  norm_act_bwd_stats_partial<T><<<dim3(nchunk, N), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<const T*>(g), static_cast<float*>(part), S, C,
      per_chunk(S, nchunk), slope, act);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  norm_act_finalize<<<N, THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(gsums), nchunk, C,
      0.f, 0.f, 0);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dx_impl(const void* x, const void* stats, const void* gsums,
                const void* g, void* dx, int N, long long S, int C,
                int nchunk, float slope, int act, cudaStream_t st) {
  if (bad_shape(C, Vec<T>::N, nchunk)) return (int)cudaErrorInvalidValue;
  norm_act_bwd_dx<T><<<dim3(nchunk, N), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(gsums), static_cast<const T*>(g),
      static_cast<T*>(dx), S, C, per_chunk(S, nchunk), slope, act,
      (float)(1.0 / (double)S));
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher runs on `stream` and returns the cudaGetLastError() code of
// its launches. Tensors are (N, S, C) in bf16 (is_bf16) or fp32; stats and
// gsums are (N, 2, C) fp32; part is (N, nchunk, 2, C) fp32 scratch.

extern "C" int norm_act_stats_launch(const void* x, void* part, void* stats,
                                     int N, long long S, int C, int nchunk,
                                     float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? stats_impl<__nv_bfloat16>(x, part, stats, N, S, C, nchunk,
                                             eps, st)
                 : stats_impl<float>(x, part, stats, N, S, C, nchunk, eps, st);
}

extern "C" int norm_act_norm_launch(const void* x, const void* stats, void* y,
                                    int N, long long S, int C, int nchunk,
                                    float slope, int act, int is_bf16,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? norm_impl<__nv_bfloat16>(x, stats, y, N, S, C, nchunk,
                                            slope, act, st)
                 : norm_impl<float>(x, stats, y, N, S, C, nchunk, slope, act,
                                    st);
}

extern "C" int norm_act_bwd_stats_launch(const void* x, const void* stats,
                                         const void* g, void* part,
                                         void* gsums, int N, long long S,
                                         int C, int nchunk, float slope,
                                         int act, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_stats_impl<__nv_bfloat16>(x, stats, g, part, gsums, N,
                                                 S, C, nchunk, slope, act, st)
                 : bwd_stats_impl<float>(x, stats, g, part, gsums, N, S, C,
                                         nchunk, slope, act, st);
}

extern "C" int norm_act_bwd_dx_launch(const void* x, const void* stats,
                                      const void* gsums, const void* g,
                                      void* dx, int N, long long S, int C,
                                      int nchunk, float slope, int act,
                                      int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_dx_impl<__nv_bfloat16>(x, stats, gsums, g, dx, N, S, C,
                                              nchunk, slope, act, st)
                 : bwd_dx_impl<float>(x, stats, gsums, g, dx, N, S, C, nchunk,
                                      slope, act, st);
}
