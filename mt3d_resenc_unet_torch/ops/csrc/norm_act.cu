// Instance norm + LeakyReLU over (N, S, C) channels-last tensors, forward
// and backward, and the model's norm tail, for Hopper (sm_90a). bf16, fp16
// or fp32 in, fp32 statistics. Plain C interface, bound with ctypes
// (ops/norm_act.py).
//
// Replaces the TPU's Pallas kernels of
//   mt3d_resenc_unet_tpu/ops/pallas_norm_act.py
//   _stats_kernel      -> norm_act_stats      ([mean; inv]), and
//                         norm_act_raw_stats  ([sum x; sum x^2], the
//                         statistics of instance_norm.py packed_stats_xla)
//   _norm_kernel       -> norm_act_norm, and
//                         norm_act_tail       (instance_norm.py
//                         norm_apply_packed: (inv, shift) form, residual,
//                         residual_pre, LeakyReLU)
//   _bwd_stats_kernel  -> norm_act_bwd_stats, and
//                         norm_act_tail_bwd   (norm_apply_packed's
//                         backward: the cotangents and the vectors' sums)
//   _bwd_dx_kernel     -> norm_act_bwd_dx
// computing what they compute, in the same arithmetic: the statistics are
// E[x^2] - mean^2 in fp32, clamped at 0, inv = rsqrt(var + eps); the
// normalize runs in x's dtype after mean and inv are rounded to it; the
// backward rebuilds fp32 xhat from the fp32 mean and inv. The tail computes
// in fp32 with one rounding at the store, each operation rounded as the
// port's eager ops round it (__fmul_rn / __fadd_rn: no contraction), so its
// forward and the mask its backward rebuilds are those of the eager ops.
//
// What bounds them on the H100: bytes. Each reads its tensors once with a
// handful of fp32 operations per element, far under the card's 67 TFLOP/s
// of fp32 for 3.35 TB/s of HBM. The design keeps enough bytes in flight:
//   * the channel dimension is innermost, so a warp's threads run along C
//     with one 16-byte vector each (8 bf16 / fp16 or 4 fp32 channels) and a
//     block covers rows = 256 / (C / vec) voxels at a time;
//   * the grid is sized to the card (ops/norm_act.py::_chunks: about two
//     blocks an SM over N x chunks, each of at least 128 KB of the tensor),
//     and each thread issues UNROLL (STATS_UNROLL) independent 16-byte
//     loads of each tensor per loop trip before it adds;
//   * a block reduces its per-thread sums by warp shuffles over the rows a
//     warp holds, then a tree in shared memory over the warps (or rows),
//     every thread adding;
//   * the reductions finalize in the same launch: each block stores its
//     chunk's partial, and the last block of a sample to arrive (an integer
//     arrival counter per sample, reset by that block) adds the sample's
//     partials with all its threads, four columns a thread as one 16-byte
//     vector, the chunks split over thread groups in a fixed interleave,
//     each thread keeping FIN independent sums so that FIN vector reads of
//     the L2 are in flight, and the groups added by the same tree.
// Every sum runs in an order fixed by the shapes alone: no floating-point
// atomics, the same bits on every run. The one atomic is the integer
// ticket that elects the finalizing block.
//
// norm_act_norm and norm_act_bwd_dx keep their first design (one vector a
// thread per trip over (chunk, n) blocks of ROWS_PER_THREAD rows).
//
// Requirements (checked by the wrapper): contiguous tensors, 16-byte
// aligned, C a multiple of the vector width with C / vec <= 256; (N, C)
// fp32 vectors; counters of at least N ints, zero at the launch.

#include "b16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;        // rows a thread loads per trip, per tensor
constexpr int STATS_UNROLL = 8;  // the statistics read one tensor

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec<__half> {
  static constexpr int N = 8;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};

// the 16-bit types: 8 channels a vector, as 4 pairs
template <class T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const b16x2<T>* h = reinterpret_cast<const b16x2<T>*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = to_f2(h[i]);
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

template <class T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  uint4 q;
  b16x2<T>* h = reinterpret_cast<b16x2<T>*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = pack2<T>(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// One 16-byte vector kept packed in registers until it is used (8 bf16 or
// fp16 in 4 registers, not 8), so that UNROLL of them per tensor are in flight.
template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <class T>
__device__ __forceinline__ void unpack(const uint4& q, float* v, const T*) {
  const b16x2<T>* h = reinterpret_cast<const b16x2<T>*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = to_f2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& q, float* v,
                                       const float*) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

// v rounded to T and back: the rounding of one operation in T's arithmetic
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const __half*) {
  return __half2float(__float2half_rn(v));
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

// ------------------------------------------------------------ reductions

__device__ __forceinline__ int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Shared memory of a reducing kernel: K * THREADS * VN floats, which holds
// the block's rows of K sums (rows * C <= THREADS * VN) and, after them,
// the finalize's group sums and totals.
template <int K, int VN>
struct Smem {
  static constexpr int FLOATS = K * THREADS * VN;
};

// Sum K per-thread vectors acc[k][0:VN] over the block's rows: the
// block's fp32 partial, K*C floats at part ([k][c]). Where a warp holds
// several rows of each vector column (cols a power of two below 32), warp
// shuffles first add its rows (lanes lane ^ off, off = 16 ... cols, share
// a column); then a tree in shared memory `red` adds the warps' (or, for
// cols >= 32, the rows') sums: row r's K*C sums at red[r * K*C], and after
// step h rows [0, h) hold the sums of rows [0, 2h). Every thread adds, in
// an order fixed by the shapes.
template <int K, int VN>
__device__ __forceinline__ void block_reduce_store(const Geometry& g, int C,
                                                   float (&acc)[K][VN],
                                                   float* __restrict__ red,
                                                   float* __restrict__ part) {
  const int width = K * C;
  int live = g.rows;
  if (g.cols < 32 && 32 % g.cols == 0) {  // every thread is active
    for (int off = 16; off >= g.cols; off >>= 1)
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < VN; ++j)
          acc[k][j] += __shfl_xor_sync(0xffffffffu, acc[k][j], off);
    live = THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane < g.cols) {  // lane == cv
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < VN; ++j)
          red[warp * width + k * C + lane * VN + j] = acc[k][j];
    }
  } else if (g.active) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < VN; ++j)
        red[g.r * width + k * C + g.cv * VN + j] = acc[k][j];
  }
  __syncthreads();
  for (int h = pow2_ceil(live) >> 1; h > 0; h >>= 1) {
    if (g.active && g.r < h && g.r + h < live) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < VN; ++j) {
          const int m = k * C + g.cv * VN + j;
          red[g.r * width + m] += red[(g.r + h) * width + m];
        }
    }
    __syncthreads();
  }
  for (int m = threadIdx.x; m < width; m += THREADS) part[m] = red[m];
}

// Arrival of a block at the end of its partial: returns true in the last
// block of sample n to arrive, which then owns the sample's finalize. The
// fence makes this block's partial visible before its ticket; the last
// block resets the counter for the next launch on the stream.
__device__ __forceinline__ bool last_to_arrive(int* __restrict__ counter,
                                               int n, int nchunk) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ticket = atomicAdd(&counter[n], 1);
    last = ticket == nchunk - 1;
    if (last) counter[n] = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Columns 4 m4 .. 4 m4 + 3 of the partials k = k0, k0 + step, ... < nchunk
// at pn, read as one 16-byte vector each and added into FIN independent
// sums (so FIN vector loads of the L2 are in flight, not a chain of
// dependent adds), which are then added in a fixed order.
constexpr int FIN = 8;
__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

__device__ __forceinline__ float4 column_sum4(const float* __restrict__ pn,
                                              int nchunk, int width, int m4,
                                              int k0, int step) {
  float4 acc[FIN];
#pragma unroll
  for (int q = 0; q < FIN; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = k0; k < nchunk; k += FIN * step) {
#pragma unroll
    for (int q = 0; q < FIN; ++q) {
      const int kk = k + q * step;
      if (kk < nchunk)
        acc[q] = add4(acc[q], __ldcg(reinterpret_cast<const float4*>(
                                  pn + (size_t)kk * width) + m4));
    }
  }
#pragma unroll
  for (int h = FIN / 2; h > 0; h >>= 1)
#pragma unroll
    for (int q = 0; q < h; ++q) acc[q] = add4(acc[q], acc[q + h]);
  return acc[0];
}

// The finalize of sample n, run by its last block: the totals of the
// nchunk partials of `width` floats (a multiple of 4) at pn, returned in
// shared memory (the pointer it returns, `width` floats, valid in every
// thread). In parallel and in a fixed order: over W4 = width / 4 vector
// columns, G = THREADS / W4 thread groups (1 when W4 > THREADS) each add
// the chunks g, g + G, g + 2G, ... (column_sum4), reading L2 (the other
// blocks' partials), then a tree adds the groups. `smem` is 16-byte
// aligned and holds at least max(4 * THREADS, width) floats.
__device__ __forceinline__ const float* finalize_sums(
    const float* __restrict__ pn, int nchunk, int width,
    float* __restrict__ smem) {
  float4* s4 = reinterpret_cast<float4*>(smem);
  const int w4 = width / 4;
  if (w4 > THREADS) {
    for (int m4 = threadIdx.x; m4 < w4; m4 += THREADS)
      s4[m4] = column_sum4(pn, nchunk, width, m4, 0, 1);
    __syncthreads();
    return smem;
  }
  const int groups = THREADS / w4;
  const int m4 = threadIdx.x % w4;
  const int grp = threadIdx.x / w4;
  s4[threadIdx.x] = grp < groups
                        ? column_sum4(pn, nchunk, width, m4, grp, groups)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int h = pow2_ceil(groups) >> 1; h > 0; h >>= 1) {
    if (grp < h && grp + h < groups)
      s4[grp * w4 + m4] = add4(s4[grp * w4 + m4], s4[(grp + h) * w4 + m4]);
    __syncthreads();
  }
  return smem;
}

// ------------------------------------------------- _stats_kernel, two modes

// Per-(n, c) [sum x; sum x^2] of the block's chunk into acc.
template <typename T>
__device__ __forceinline__ void stats_pass(const T* __restrict__ xn,
                                           const Geometry& g, int C,
                                           float (&acc)[2][Vec<T>::N]) {
  constexpr int VN = Vec<T>::N;
#pragma unroll
  for (int j = 0; j < VN; ++j) acc[0][j] = acc[1][j] = 0.f;
  if (!g.active) return;
  const T* base = xn + g.cv * VN;
  for (long long i = g.r0 + g.r; i < g.r1;
       i += (long long)g.rows * STATS_UNROLL) {
    uint4 q[STATS_UNROLL];
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u) {
      const long long ii = i + (long long)u * g.rows;
      q[u] = ii < g.r1 ? ld16(base + (size_t)ii * C) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u) {
      float v[VN];
      unpack(q[u], v, base);
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        acc[0][j] += v[j];
        acc[1][j] = fmaf(v[j], v[j], acc[1][j]);
      }
    }
  }
}

// The whole of _stats_kernel in one launch: grid (nchunk, N). RAW: out =
// (N, 2, C) [sum x; sum x^2]; otherwise [mean; rsqrt(max(E[x^2] - mean^2,
// 0) + eps)].
template <typename T, bool RAW>
__device__ __forceinline__ void stats_body(const T* __restrict__ x,
                                           float* __restrict__ part,
                                           int* __restrict__ counter,
                                           float* __restrict__ out,
                                           long long S, int C,
                                           long long per_chunk, float inv_s,
                                           float eps) {
  constexpr int VN = Vec<T>::N;
  const Geometry g(S, C, VN, per_chunk);
  const int n = blockIdx.y, nchunk = gridDim.x;
  float acc[2][VN];
  stats_pass<T>(x + (size_t)n * S * C, g, C, acc);
  __shared__ __align__(16) float smem[Smem<2, VN>::FLOATS];
  float* pn = part + (size_t)n * nchunk * 2 * C;
  block_reduce_store<2, VN>(g, C, acc, smem, pn + (size_t)blockIdx.x * 2 * C);
  if (!last_to_arrive(counter, n, nchunk)) return;
  const float* tot = finalize_sums(pn, nchunk, 2 * C, smem);
  float* on = out + (size_t)n * 2 * C;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float a = tot[c], b = tot[C + c];
    if (!RAW) {
      const float mean = a * inv_s;
      const float var = b * inv_s - mean * mean;
      a = mean;
      b = rsqrtf(fmaxf(var, 0.f) + eps);
    }
    on[c] = a;
    on[C + c] = b;
  }
}

// Four blocks an SM (the grid's size, ops/norm_act.py::_chunks), so at
// most 64 registers a thread.
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
norm_act_stats(const T* __restrict__ x, float* __restrict__ part,
               int* __restrict__ counter, float* __restrict__ out,
               long long S, int C, long long per_chunk, float inv_s,
               float eps) {
  stats_body<T, false>(x, part, counter, out, S, C, per_chunk, inv_s, eps);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
norm_act_raw_stats(const T* __restrict__ x, float* __restrict__ part,
                   int* __restrict__ counter, float* __restrict__ out,
                   long long S, int C, long long per_chunk) {
  stats_body<T, true>(x, part, counter, out, S, C, per_chunk, 0.f, 0.f);
}

// ------------------------------------------------------------ _norm_kernel

// y = (x - mean) * inv [then LeakyReLU], every operation rounded to T as
// the TPU kernel computes in x's dtype.
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

// ------------------------------------------------------- the norm tail

// The tail's per-(n, c) vectors for the thread's VN channels: inv, shift,
// and residual_pre's (a, b) where given.
template <int VN>
struct TailVectors {
  float inv[VN], shift[VN], a[VN], b[VN];
  __device__ TailVectors(const float* __restrict__ inv_p,
                         const float* __restrict__ shift_p,
                         const float* __restrict__ a_p,
                         const float* __restrict__ b_p, size_t at) {
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      inv[j] = inv_p[at + j];
      shift[j] = shift_p[at + j];
      a[j] = a_p ? a_p[at + j] : 0.f;
      b[j] = b_p ? b_p[at + j] : 0.f;
    }
  }
};

// The tail's pre-activations of one element, each operation rounded as the
// eager ops round it: t = r * a - b (the residual's, with residual_pre),
// rr = the residual term, u = y * inv - shift [+ rr].
__device__ __forceinline__ float tail_u(float yv, float rv, float inv,
                                        float shift, float a, float b,
                                        float slope, int has_res, int has_pre,
                                        float* t) {
  float u = __fsub_rn(__fmul_rn(yv, inv), shift);
  if (has_res) {
    float rr = rv;
    if (has_pre) {
      *t = __fsub_rn(__fmul_rn(rv, a), b);
      rr = *t >= 0.f ? *t : __fmul_rn(*t, slope);
    }
    u = __fadd_rn(u, rr);
  }
  return u;
}

// norm_apply_packed: out = leaky((y * inv - shift) [+ residual]) [act],
// residual = leaky(r * a - b) with residual_pre; fp32 inside, one rounding
// at the store.
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_act_tail(const T* __restrict__ y, const T* __restrict__ res,
              const float* __restrict__ inv_p,
              const float* __restrict__ shift_p,
              const float* __restrict__ a_p, const float* __restrict__ b_p,
              T* __restrict__ out, long long S, int C, long long per_chunk,
              float slope, int act) {
  constexpr int VN = Vec<T>::N;
  const Geometry g(S, C, VN, per_chunk);
  if (!g.active) return;
  const int n = blockIdx.y;
  const int has_res = res != nullptr, has_pre = a_p != nullptr;
  const TailVectors<VN> vec(inv_p, shift_p, a_p, b_p,
                            (size_t)n * C + g.cv * VN);
  const size_t base = (size_t)n * S * C + g.cv * VN;
  for (long long i = g.r0 + g.r; i < g.r1; i += (long long)g.rows * UNROLL) {
    uint4 yq[UNROLL], rq[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long ii = i + (long long)u * g.rows;
      yq[u] = rq[u] = make_uint4(0, 0, 0, 0);
      if (ii < g.r1) {
        yq[u] = ld16(y + base + (size_t)ii * C);
        if (has_res) rq[u] = ld16(res + base + (size_t)ii * C);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long ii = i + (long long)u * g.rows;
      if (ii >= g.r1) break;
      float yv[VN], rv[VN], o[VN];
      unpack(yq[u], yv, y);
      unpack(rq[u], rv, y);
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        float t;
        float v = tail_u(yv[j], rv[j], vec.inv[j], vec.shift[j], vec.a[j],
                         vec.b[j], slope, has_res, has_pre, &t);
        if (act && !(v >= 0.f)) v = __fmul_rn(v, slope);
        o[j] = v;
      }
      store_vec(out + base + (size_t)ii * C, o);
    }
  }
}

// norm_apply_packed's backward in one pass over y, the residual and the
// cotangent: g' = g through the LeakyReLU's mask (rebuilt from u as the
// forward computed it); dy = g' * inv and dr = g' (with residual_pre: g_r *
// a, g_r = g' through the residual's mask), rounded to T; per (n, c) the
// fp32 sums [sum g' y; -sum g'] and, with residual_pre, [sum g_r r; -sum
// g_r]: the gradients of (inv, shift) and (a, b). Grid (nchunk, N), one
// launch: the last block of each sample adds the partials.
template <typename T, int K>
__device__ __forceinline__ void tail_bwd_body(
    const T* __restrict__ y, const T* __restrict__ res,
    const float* __restrict__ inv_p, const float* __restrict__ shift_p,
    const float* __restrict__ a_p, const float* __restrict__ b_p,
    const T* __restrict__ gy, T* __restrict__ dy, T* __restrict__ dr,
    float* __restrict__ part, int* __restrict__ counter,
    float* __restrict__ sums, long long S, int C, long long per_chunk,
    float slope, int act) {
  constexpr int VN = Vec<T>::N;
  const Geometry g(S, C, VN, per_chunk);
  const int n = blockIdx.y, nchunk = gridDim.x;
  const int has_res = res != nullptr, has_pre = a_p != nullptr;
  float acc[K][VN];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < VN; ++j) acc[k][j] = 0.f;
  if (g.active) {
    const TailVectors<VN> vec(inv_p, shift_p, a_p, b_p,
                              (size_t)n * C + g.cv * VN);
    const size_t base = (size_t)n * S * C + g.cv * VN;
    for (long long i = g.r0 + g.r; i < g.r1;
         i += (long long)g.rows * UNROLL) {
      uint4 yq[UNROLL], rq[UNROLL], gq[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long ii = i + (long long)u * g.rows;
        yq[u] = rq[u] = gq[u] = make_uint4(0, 0, 0, 0);
        if (ii < g.r1) {
          yq[u] = ld16(y + base + (size_t)ii * C);
          gq[u] = ld16(gy + base + (size_t)ii * C);
          if (has_res) rq[u] = ld16(res + base + (size_t)ii * C);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long ii = i + (long long)u * g.rows;
        if (ii >= g.r1) break;
        float yv[VN], rv[VN], gv[VN], od[VN], orr[VN];
        unpack(yq[u], yv, y);
        unpack(rq[u], rv, y);
        unpack(gq[u], gv, y);
#pragma unroll
        for (int j = 0; j < VN; ++j) {
          float t = 0.f;
          const float r = rv[j];
          const float uu = tail_u(yv[j], r, vec.inv[j], vec.shift[j],
                                  vec.a[j], vec.b[j], slope, has_res,
                                  has_pre, &t);
          const float gp = (act && !(uu >= 0.f)) ? __fmul_rn(gv[j], slope)
                                                 : gv[j];
          od[j] = __fmul_rn(gp, vec.inv[j]);
          acc[0][j] = fmaf(gp, yv[j], acc[0][j]);
          acc[1][j] += gp;
          orr[j] = gp;
          if constexpr (K == 4) {
            const float gr = t >= 0.f ? gp : __fmul_rn(gp, slope);
            orr[j] = __fmul_rn(gr, vec.a[j]);
            acc[2][j] = fmaf(gr, r, acc[2][j]);
            acc[3][j] += gr;
          }
        }
        store_vec(dy + base + (size_t)ii * C, od);
        if (has_res) store_vec(dr + base + (size_t)ii * C, orr);
      }
    }
  }
  __shared__ __align__(16) float smem[Smem<K, VN>::FLOATS];
  float* pn = part + (size_t)n * nchunk * K * C;
  block_reduce_store<K, VN>(g, C, acc, smem, pn + (size_t)blockIdx.x * K * C);
  if (!last_to_arrive(counter, n, nchunk)) return;
  const float* tot = finalize_sums(pn, nchunk, K * C, smem);
  float* sn = sums + (size_t)n * K * C;
  for (int m = threadIdx.x; m < K * C; m += THREADS) {
    // rows 1 and 3 are the shifts' gradients: -sum
    const int k = m / C;
    sn[m] = (k & 1) ? -tot[m] : tot[m];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_act_tail_bwd(const T* __restrict__ y, const T* __restrict__ res,
                  const float* __restrict__ inv_p,
                  const float* __restrict__ shift_p,
                  const T* __restrict__ gy, T* __restrict__ dy,
                  T* __restrict__ dr, float* __restrict__ part,
                  int* __restrict__ counter, float* __restrict__ sums,
                  long long S, int C, long long per_chunk, float slope,
                  int act) {
  tail_bwd_body<T, 2>(y, res, inv_p, shift_p, nullptr, nullptr, gy, dy, dr,
                      part, counter, sums, S, C, per_chunk, slope, act);
}

// the same with residual_pre (a, b): four sums per (n, c)
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_act_tail_bwd_pre(const T* __restrict__ y, const T* __restrict__ res,
                      const float* __restrict__ inv_p,
                      const float* __restrict__ shift_p,
                      const float* __restrict__ a_p,
                      const float* __restrict__ b_p, const T* __restrict__ gy,
                      T* __restrict__ dy, T* __restrict__ dr,
                      float* __restrict__ part, int* __restrict__ counter,
                      float* __restrict__ sums, long long S, int C,
                      long long per_chunk, float slope, int act) {
  tail_bwd_body<T, 4>(y, res, inv_p, shift_p, a_p, b_p, gy, dy, dr, part,
                      counter, sums, S, C, per_chunk, slope, act);
}

// ------------------------------------------------------ the op's backward

// fp32 xhat and the cotangent after the LeakyReLU backward, as both
// backward TPU kernels compute them
__device__ __forceinline__ void grad_in(float xv, float gv, float mean,
                                        float inv, float slope, int act,
                                        float* xhat, float* gp) {
  *xhat = (xv - mean) * inv;
  *gp = (act && !(*xhat >= 0.f)) ? gv * slope : gv;
}

// The whole of _bwd_stats_kernel in one launch: out = (N, 2, C) fp32
// [sum g'; sum g' * xhat].
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_act_bwd_stats(const T* __restrict__ x, const float* __restrict__ stats,
                   const T* __restrict__ gy, float* __restrict__ part,
                   int* __restrict__ counter, float* __restrict__ out,
                   long long S, int C, long long per_chunk, float slope,
                   int act) {
  constexpr int VN = Vec<T>::N;
  const Geometry g(S, C, VN, per_chunk);
  const int n = blockIdx.y, nchunk = gridDim.x;
  float acc[2][VN];
#pragma unroll
  for (int j = 0; j < VN; ++j) acc[0][j] = acc[1][j] = 0.f;
  if (g.active) {
    float mean[VN], inv[VN];
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      mean[j] = stats[(size_t)n * 2 * C + g.cv * VN + j];
      inv[j] = stats[(size_t)n * 2 * C + C + g.cv * VN + j];
    }
    const size_t base = (size_t)n * S * C + g.cv * VN;
    for (long long i = g.r0 + g.r; i < g.r1;
         i += (long long)g.rows * UNROLL) {
      uint4 xq[UNROLL], gq[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long ii = i + (long long)u * g.rows;
        xq[u] = gq[u] = make_uint4(0, 0, 0, 0);
        if (ii < g.r1) {
          xq[u] = ld16(x + base + (size_t)ii * C);
          gq[u] = ld16(gy + base + (size_t)ii * C);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long ii = i + (long long)u * g.rows;
        if (ii >= g.r1) break;
        float v[VN], w[VN];
        unpack(xq[u], v, x);
        unpack(gq[u], w, x);
#pragma unroll
        for (int j = 0; j < VN; ++j) {
          float xhat, gp;
          grad_in(v[j], w[j], mean[j], inv[j], slope, act, &xhat, &gp);
          acc[0][j] += gp;
          acc[1][j] = fmaf(gp, xhat, acc[1][j]);
        }
      }
    }
  }
  __shared__ __align__(16) float smem[Smem<2, VN>::FLOATS];
  float* pn = part + (size_t)n * nchunk * 2 * C;
  block_reduce_store<2, VN>(g, C, acc, smem, pn + (size_t)blockIdx.x * 2 * C);
  if (!last_to_arrive(counter, n, nchunk)) return;
  const float* tot = finalize_sums(pn, nchunk, 2 * C, smem);
  for (int m = threadIdx.x; m < 2 * C; m += THREADS)
    out[(size_t)n * 2 * C + m] = tot[m];
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

// ---------------------------------------------------------------- launchers

bool bad_shape(int C, int vn, int nchunk) {
  return C <= 0 || C % vn != 0 || C / vn > THREADS || nchunk < 1 ||
         nchunk > 65535;
}

long long per_chunk(long long S, int nchunk) {
  return (S + nchunk - 1) / nchunk;
}

float inv_count(long long S) { return (float)(1.0 / (double)S); }

template <typename T>
int stats_impl(const void* x, void* part, void* counter, void* out, int N,
               long long S, int C, int nchunk, float eps, int raw,
               cudaStream_t st) {
  if (bad_shape(C, Vec<T>::N, nchunk)) return (int)cudaErrorInvalidValue;
  const dim3 grid(nchunk, N);
  if (raw)
    norm_act_raw_stats<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<float*>(part),
        static_cast<int*>(counter), static_cast<float*>(out), S, C,
        per_chunk(S, nchunk));
  else
    norm_act_stats<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<float*>(part),
        static_cast<int*>(counter), static_cast<float*>(out), S, C,
        per_chunk(S, nchunk), inv_count(S), eps);
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
int tail_impl(const void* y, const void* res, const void* inv,
              const void* shift, const void* a, const void* b, void* out,
              int N, long long S, int C, int nchunk, float slope, int act,
              cudaStream_t st) {
  if (bad_shape(C, Vec<T>::N, nchunk) || (a == nullptr) != (b == nullptr) ||
      (a != nullptr && res == nullptr))
    return (int)cudaErrorInvalidValue;
  norm_act_tail<T><<<dim3(nchunk, N), THREADS, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(res),
      static_cast<const float*>(inv), static_cast<const float*>(shift),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(out), S, C, per_chunk(S, nchunk), slope, act);
  return (int)cudaGetLastError();
}

template <typename T>
int tail_bwd_impl(const void* y, const void* res, const void* inv,
                  const void* shift, const void* a, const void* b,
                  const void* gy, void* dy, void* dr, void* part,
                  void* counter, void* sums, int N, long long S, int C,
                  int nchunk, float slope, int act, cudaStream_t st) {
  if (bad_shape(C, Vec<T>::N, nchunk) || (a == nullptr) != (b == nullptr) ||
      (a != nullptr && res == nullptr) || (res == nullptr) != (dr == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nchunk, N);
  const long long pc = per_chunk(S, nchunk);
  if (a != nullptr)
    norm_act_tail_bwd_pre<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(y), static_cast<const T*>(res),
        static_cast<const float*>(inv), static_cast<const float*>(shift),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const T*>(gy), static_cast<T*>(dy), static_cast<T*>(dr),
        static_cast<float*>(part), static_cast<int*>(counter),
        static_cast<float*>(sums), S, C, pc, slope, act);
  else
    norm_act_tail_bwd<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(y), static_cast<const T*>(res),
        static_cast<const float*>(inv), static_cast<const float*>(shift),
        static_cast<const T*>(gy), static_cast<T*>(dy), static_cast<T*>(dr),
        static_cast<float*>(part), static_cast<int*>(counter),
        static_cast<float*>(sums), S, C, pc, slope, act);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_stats_impl(const void* x, const void* stats, const void* g,
                   void* part, void* counter, void* gsums, int N, long long S,
                   int C, int nchunk, float slope, int act, cudaStream_t st) {
  if (bad_shape(C, Vec<T>::N, nchunk)) return (int)cudaErrorInvalidValue;
  norm_act_bwd_stats<T><<<dim3(nchunk, N), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<const T*>(g), static_cast<float*>(part),
      static_cast<int*>(counter), static_cast<float*>(gsums), S, C,
      per_chunk(S, nchunk), slope, act);
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
      inv_count(S));
  return (int)cudaGetLastError();
}

// the launcher's body for dtype `code` (fp32 or a 16-bit type)
template <class F>
int dtype_dispatch(int code, F f) {
  return code == DT_F32 ? f(float()) : b16_dispatch(code, f);
}

}  // namespace

// Each launcher runs on `stream` and returns the cudaGetLastError() code of
// its launch. Tensors are (N, S, C) in fp32, bf16 or fp16 (`dtype`, a
// DT_* code of b16.cuh); stats and gsums are (N, 2, C) fp32; inv, shift, a,
// b are (N, C) fp32 (a, b and the residual may be null); part is (N,
// nchunk, K, C) fp32 scratch; counter holds N ints that are 0 at the launch
// and 0 again after it.

extern "C" int norm_act_stats_launch(const void* x, void* part, void* counter,
                                     void* out, int N, long long S, int C,
                                     int nchunk, float eps, int raw,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype_dispatch(dtype, [&](auto t) {
    return stats_impl<decltype(t)>(x, part, counter, out, N, S, C, nchunk, eps,
                                   raw, st);
  });
}

extern "C" int norm_act_norm_launch(const void* x, const void* stats, void* y,
                                    int N, long long S, int C, int nchunk,
                                    float slope, int act, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype_dispatch(dtype, [&](auto t) {
    return norm_impl<decltype(t)>(x, stats, y, N, S, C, nchunk, slope, act, st);
  });
}

extern "C" int norm_act_tail_launch(const void* y, const void* res,
                                    const void* inv, const void* shift,
                                    const void* a, const void* b, void* out,
                                    int N, long long S, int C, int nchunk,
                                    float slope, int act, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype_dispatch(dtype, [&](auto t) {
    return tail_impl<decltype(t)>(y, res, inv, shift, a, b, out, N, S, C,
                                  nchunk, slope, act, st);
  });
}

extern "C" int norm_act_tail_bwd_launch(
    const void* y, const void* res, const void* inv, const void* shift,
    const void* a, const void* b, const void* gy, void* dy, void* dr,
    void* part, void* counter, void* sums, int N, long long S, int C,
    int nchunk, float slope, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype_dispatch(dtype, [&](auto t) {
    return tail_bwd_impl<decltype(t)>(y, res, inv, shift, a, b, gy, dy, dr,
                                      part, counter, sums, N, S, C, nchunk,
                                      slope, act, st);
  });
}

extern "C" int norm_act_bwd_stats_launch(const void* x, const void* stats,
                                         const void* g, void* part,
                                         void* counter, void* gsums, int N,
                                         long long S, int C, int nchunk,
                                         float slope, int act, int dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype_dispatch(dtype, [&](auto t) {
    return bwd_stats_impl<decltype(t)>(x, stats, g, part, counter, gsums, N, S,
                                       C, nchunk, slope, act, st);
  });
}

extern "C" int norm_act_bwd_dx_launch(const void* x, const void* stats,
                                      const void* gsums, const void* g,
                                      void* dx, int N, long long S, int C,
                                      int nchunk, float slope, int act,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype_dispatch(dtype, [&](auto t) {
    return bwd_dx_impl<decltype(t)>(x, stats, gsums, g, dx, N, S, C, nchunk,
                                    slope, act, st);
  });
}
