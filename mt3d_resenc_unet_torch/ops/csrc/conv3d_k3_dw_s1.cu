// Weight gradient (dW) of the stride-1 3x3x3 pad-1 convolution on NDHWC
// bf16, on the tensor cores, for Hopper (sm_90a). Plain C interface, bound
// with ctypes (ops/conv3d.py conv3d_k3_dw at stride 1). The stride-2 dW,
// conv3d_k3_dw_s2.cu, shares this design with its input staged by parity
// and a deterministic sum across blocks.
//
// Replaces the TPU's Pallas kernel
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_dw_kernel (via
//     conv3d_dw_packed: the weight gradient of every stride-1 packed conv)
// It computes, in fp32 over all samples and voxels v,
//   dW[k, ci, co] = sum_v xin[v + k - 1, ci] * g[v, co]
// with xin zero outside the volume, and the TPU kernel's fusions:
//   PRE   xin = leaky(x*scale - shift), the producer's norm applied once per
//         staged element; the padding stays zero after it;
//   CORR  g = gy + gs[0] + 2*y*gs[1], built once per staged element; a voxel
//         outside the volume stays 0.
//
// What bounds it on the H100: the tensor cores. A dW value takes 2*N*V
// FLOPs (V voxels per sample), 2*27*Ci FLOPs per gy value: at 128^3 x
// 32 -> 32, N=2, 232 GFLOP against 0.54-0.81 GB read (0.24 ms of bf16 peak,
// 0.16-0.24 ms of HBM).
//
// Design: 27 GEMMs, one per tap, dW[k] (Ci x Co) = X_k^T G, with K the
// voxels, on mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
//   Tiles. A block owns all 27 taps of a 32 ci x 32 co tile: 9 warps, one
//     per (kd, kh), each holding the three kw taps' 32 x 32 sums (96 fp32
//     registers a thread), for the whole K range it is given.
//   Loads. The K loop runs over bricks of 2 x 8 x 8 = 128 voxels. For each
//     brick the block stages, with cp.async into a 2-stage ring, the halo'd
//     x brick (4 x 10 x 10 voxels x 32 channels, zero-filled outside the
//     volume), the g brick (128 voxels x 32 channels) and y's in CORR mode;
//     the next brick's copies run while this one's products do. Rows are 64
//     bytes with their 16-byte quarters permuted by row / 2, so the 8 rows
//     of any ldmatrix phase hit 8 distinct bank groups.
//   Prologues once per element. PRE rewrites the staged x brick in place
//     and CORR the g brick, once per brick; every tap of the block then
//     reads the same two bricks (the direct kernel it replaces re-read x and
//     gy 27 * (Ci/32) * (Co/32) times and rebuilt both per tap and tile).
//   Operands. Both products take their operands transposed from the
//     voxel-major bricks: ldmatrix.trans gives X_k^T (rows ci) from the x
//     brick at the tap's shifted rows and G (k = voxel, n = co) from the g
//     brick. The g fragments of a 16-voxel step serve all three taps of a
//     warp.
//   Deterministic reduction across bricks. The planner (ops/conv3d.py
//     _dw_s1_plan) cuts the bricks into `splits` contiguous ranges so that
//     tiles x splits blocks fill the SMs once; each block stores its
//     finished 27 x 32 x 32 sums to its own slice of an fp32 (splits, 27,
//     Ci, Co) scratch (132 slices, 14.6 MB at 128^3 x 32 -> 32 on 132 SMs),
//     and conv3d_k3_dw_s1_sum adds the slices in split order. No atomics:
//     two runs on the same inputs give bit-equal dW.
//
// Requirements (checked by the wrapper and here): Ci % 32 == 0,
// Co % 32 == 0, contiguous 16-byte aligned x, gy, y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BD = 2, BH = 8, BW = 8;                 // brick of voxels
constexpr int BV = BD * BH * BW;                      // 128: K per stage
constexpr int HD = BD + 2, HH = BH + 2, HW = BW + 2;  // halo'd x brick
constexpr int HALO = HD * HH * HW;                    // 400 rows
constexpr int CT = 32;                                // ci and co per tile
constexpr int ROW = CT * 2;                           // 64-byte rows
constexpr int WARPS = 9;
constexpr int THREADS = 32 * WARPS;
constexpr int X_BYTES = HALO * ROW;                   // 25600
constexpr int G_BYTES = BV * ROW;                     // 8192
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte quarter `c` of staged row `r` (the swizzle)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW + ((c ^ (r >> 1)) & 3) * 16;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Geom {
  int N, D, H, W, Ci, Co;
  int nbh, nbw, NB;   // bricks per axis (h, w) and per sample
};

struct Brick {
  int n, d0, h0, w0;
};

// brick index b = ((n * nbd + bd) * nbh + bh) * nbw + bw, as _dw_s1_plan
__device__ __forceinline__ Brick decode(const Geom& g, int b) {
  Brick t;
  t.w0 = (b % g.nbw) * BW;
  b /= g.nbw;
  t.h0 = (b % g.nbh) * BH;
  b /= g.nbh;
  const int nbd = g.NB / (g.nbh * g.nbw);
  t.d0 = (b % nbd) * BD;
  t.n = b / nbd;
  return t;
}

__device__ __forceinline__ bool inside(const Geom& g, int d, int h, int w) {
  return d >= 0 && d < g.D && h >= 0 && h < g.H && w >= 0 && w < g.W;
}

template <bool CORR>
__device__ __forceinline__ void stage_loads(
    const Geom& g, const Brick& t, int ci0, int co0, unsigned char* st,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gy,
    const __nv_bfloat16* __restrict__ y) {
  const uint32_t xs = smem_u32(st);
  const uint32_t gs = xs + X_BYTES;
  const uint32_t ys = gs + G_BYTES;
  for (int i = threadIdx.x; i < 4 * HALO; i += THREADS) {
    const int r = i >> 2, c = i & 3;
    const int d = t.d0 - 1 + r / (HH * HW), h = t.h0 - 1 + (r / HW) % HH,
              w = t.w0 - 1 + r % HW;
    const bool in = inside(g, d, h, w);
    const size_t off =
        in ? ((((size_t)t.n * g.D + d) * g.H + h) * g.W + w) * g.Ci + ci0 +
                 c * 8
           : 0;
    cp_async16(xs + swz(r, c), x + off, in);
  }
  for (int i = threadIdx.x; i < 4 * BV; i += THREADS) {
    const int r = i >> 2, c = i & 3;
    const int d = t.d0 + r / (BH * BW), h = t.h0 + (r / BW) % BH,
              w = t.w0 + r % BW;
    const bool in = inside(g, d, h, w);
    const size_t off =
        in ? ((((size_t)t.n * g.D + d) * g.H + h) * g.W + w) * g.Co + co0 +
                 c * 8
           : 0;
    cp_async16(gs + swz(r, c), gy + off, in);
    if (CORR) cp_async16(ys + swz(r, c), y + off, in);
  }
}

template <bool PRE, bool CORR>
__device__ __forceinline__ void prologues(const Geom& g, const Brick& t,
                                          int ci0, int co0, unsigned char* st,
                                          const float* __restrict__ pre,
                                          const float* __restrict__ gsv,
                                          float slope) {
  if (PRE) {
    const float* sc = pre + (size_t)t.n * 2 * g.Ci + ci0;
    const float* sh = sc + g.Ci;
    for (int i = threadIdx.x; i < 4 * HALO; i += THREADS) {
      const int r = i >> 2, c = i & 3;
      if (!inside(g, t.d0 - 1 + r / (HH * HW), t.h0 - 1 + (r / HW) % HH,
                  t.w0 - 1 + r % HW))
        continue;
      uint4* p = reinterpret_cast<uint4*>(st + swz(r, c));
      uint4 q = *p;
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = c * 8 + 2 * j;
        const float2 a = __bfloat1622float2(v[j]);
        const float u0 = a.x * sc[k] - sh[k], u1 = a.y * sc[k + 1] - sh[k + 1];
        v[j] = __floats2bfloat162_rn(u0 >= 0.f ? u0 : u0 * slope,
                                     u1 >= 0.f ? u1 : u1 * slope);
      }
      *p = q;
    }
  }
  if (CORR) {
    const float* gs0 = gsv + (size_t)t.n * 2 * g.Co + co0;
    const float* gs1 = gs0 + g.Co;
    unsigned char* gb = st + X_BYTES;
    for (int i = threadIdx.x; i < 4 * BV; i += THREADS) {
      const int r = i >> 2, c = i & 3;
      if (!inside(g, t.d0 + r / (BH * BW), t.h0 + (r / BW) % BH,
                  t.w0 + r % BW))
        continue;
      uint4* p = reinterpret_cast<uint4*>(gb + swz(r, c));
      const uint4 yq = *reinterpret_cast<const uint4*>(gb + G_BYTES + swz(r, c));
      uint4 q = *p;
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&q);
      const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&yq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = c * 8 + 2 * j;
        const float2 a = __bfloat1622float2(v[j]);
        const float2 b = __bfloat1622float2(yv[j]);
        v[j] = __floats2bfloat162_rn(a.x + gs0[k] + 2.f * b.x * gs1[k],
                                     a.y + gs0[k + 1] + 2.f * b.y * gs1[k + 1]);
      }
      *p = q;
    }
  }
}

template <bool PRE, bool CORR>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_k3_dw_s1_mma(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ gy,
                    const float* __restrict__ pre,
                    const __nv_bfloat16* __restrict__ y,
                    const float* __restrict__ gsv, float* __restrict__ part,
                    Geom g, int splits, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int STAGE = X_BYTES + (CORR ? 2 : 1) * G_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nco = g.Co / CT;
  const int tile = blockIdx.x % ((g.Ci / CT) * nco);
  const int split = blockIdx.x / ((g.Ci / CT) * nco);
  const int ci0 = (tile / nco) * CT, co0 = (tile % nco) * CT;
  const int total = g.N * g.NB;
  const int b0 = (int)((long long)split * total / splits);
  const int b1 = (int)((long long)(split + 1) * total / splits);
  const int iters = b1 - b0;
  if (iters <= 0) return;

  // this warp's taps: (kd, kh) = (warp / 3, warp % 3), kw = 0, 1, 2
  const int kd = warp / 3, kh = warp % 3;
  const int q = lane >> 3, r8 = lane & 7;
  // per 16-voxel step s, lines 2s and 2s + 1 of the brick (line = bd*8+bh):
  // A (x, trans): matrices q = (k half q >> 1, ci half q & 1)
  // B (g, trans): matrices q = (k half q & 1, co half q >> 1)
  const int a_line = q >> 1, a_c = q & 1;
  const int b_line = q & 1, b_c = q >> 1;

  float acc[3][2][4][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < iters)
      stage_loads<CORR>(g, decode(g, b0 + s), ci0, co0, smem + s * STAGE, x,
                        gy, y);
    cp_commit();
  }

  for (int it = 0; it < iters; ++it) {
    unsigned char* st = smem + (it & 1) * STAGE;
    const Brick t = decode(g, b0 + it);
    cp_wait1();
    __syncthreads();
    if (PRE || CORR) {
      prologues<PRE, CORR>(g, t, ci0, co0, st, pre, gsv, slope);
      __syncthreads();
    }
    const uint32_t xs = smem_u32(st), gs = xs + X_BYTES;
#pragma unroll 2
    for (int s = 0; s < BV / 16; ++s) {
      uint32_t b[2][4];
      const int grow = (2 * s + b_line) * BW + r8;
#pragma unroll
      for (int j = 0; j < 2; ++j) ldsm_x4_t(gs + swz(grow, 2 * j + b_c), b[j]);
      const int line = 2 * s + a_line;
      const int xrow0 = ((line / BH + kd) * HH + (line % BH + kh)) * HW + r8;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4_t(xs + swz(xrow0 + kw, 2 * mt + a_c), a[mt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma16816(acc[kw][mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                     b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < iters)
      stage_loads<CORR>(g, decode(g, b0 + it + 2), ci0, co0, st, x, gy, y);
    cp_commit();
  }

  // acc[kw][mt][nt][e]: ci = 16*mt + lane/4 + 8*(e >> 1),
  // co = 8*nt + 2*(lane % 4) + (e & 1); this block's slice of the scratch
  const int gr = lane >> 2, tc = 2 * (lane & 3);
  float* mine = part + (size_t)split * 27 * g.Ci * g.Co;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    float* out = mine + (size_t)((kd * 3 + kh) * 3 + kw) * g.Ci * g.Co;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              out + (size_t)(ci0 + 16 * mt + gr + 8 * h) * g.Co + co0 +
              8 * nt + tc) =
              make_float2(acc[kw][mt][nt][2 * h], acc[kw][mt][nt][2 * h + 1]);
  }
}

// dw[i] = sum over s in order of part[s][i], i over the 27 * Ci * Co values
__global__ void __launch_bounds__(SUM_THREADS)
conv3d_k3_dw_s1_sum(const float* __restrict__ part, float* __restrict__ dw,
                    long long size, int splits) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * size + i];
  dw[i] = s;
}

template <bool P, bool C>
cudaError_t launch(int grid, cudaStream_t st, const void* x, const void* gy,
                   const void* pre, const void* y, const void* gs, void* part,
                   const Geom& g, int splits, float slope) {
  const int smem = 2 * (X_BYTES + (C ? 2 : 1) * G_BYTES);
  cudaError_t e = cudaFuncSetAttribute(
      conv3d_k3_dw_s1_mma<P, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  conv3d_k3_dw_s1_mma<P, C><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gy), static_cast<const float*>(pre),
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(gs),
      static_cast<float*>(part), g, splits, slope);
  return cudaGetLastError();
}

}  // namespace

// Launches dw = conv_backward_weight(x, gy) at stride 1 on `stream` into a
// (27, Ci, Co) fp32 buffer (written, not added to), with the voxel bricks
// cut into `splits` ranges (ops/conv3d.py _dw_s1_plan): (Ci/32) * (Co/32) *
// splits blocks, each storing its partial sums to its slice of part, an
// fp32 scratch of splits x 27 x Ci x Co. pre may be null; y and gs (the
// correction) come together or are both null. Returns the CUDA error code
// of the launches (0 on success).
extern "C" int conv3d_k3_dw_s1_ndhwc_launch(const void* x, const void* gy,
                                            const void* pre, const void* y,
                                            const void* gs, void* dw,
                                            void* part, int N, int D, int H,
                                            int W, int Ci, int Co, int splits,
                                            float slope, void* stream) {
  if (Ci % CT != 0 || Co % CT != 0 || N < 1 || D < 1 || H < 1 || W < 1 ||
      splits < 1 || (!y) != (!gs) || !part)
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N, g.D = D, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
  g.nbh = (H + BH - 1) / BH;
  g.nbw = (W + BW - 1) / BW;
  g.NB = ((D + BD - 1) / BD) * g.nbh * g.nbw;
  const long long blocks = (long long)(Ci / CT) * (Co / CT) * splits;
  const long long size = 27LL * Ci * Co;
  if (splits > N * g.NB || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  const int grid = (int)blocks;
  if (pre)
    e = y ? launch<true, true>(grid, st, x, gy, pre, y, gs, part, g, splits,
                               slope)
          : launch<true, false>(grid, st, x, gy, pre, y, gs, part, g, splits,
                                slope);
  else
    e = y ? launch<false, true>(grid, st, x, gy, pre, y, gs, part, g, splits,
                                slope)
          : launch<false, false>(grid, st, x, gy, pre, y, gs, part, g, splits,
                                 slope);
  if (e != cudaSuccess) return (int)e;
  conv3d_k3_dw_s1_sum<<<(unsigned)((size + SUM_THREADS - 1) / SUM_THREADS),
                        SUM_THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), size, splits);
  return (int)cudaGetLastError();
}
