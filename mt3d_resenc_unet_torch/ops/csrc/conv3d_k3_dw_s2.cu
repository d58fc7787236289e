// Weight gradient (dW) of the stride-2 3x3x3 pad-1 convolution on NDHWC
// bf16, on the tensor cores, for Hopper (sm_90a). Plain C interface, bound
// with ctypes (ops/conv3d.py conv3d_k3_dw at stride 2).
//
// Replaces the TPU's Pallas kernel
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_s2_dw_kernel (via
//     _conv3d_s2_dw_impl: the weight gradient of conv3d_s2_packed)
// It computes, in fp32 over all samples and output voxels o,
//   dW[k, ci, co] = sum_o xin[2o - 1 + k, ci] * g[o, co]
// with xin zero outside the volume, and the TPU kernel's fusions:
//   PRE   xin = leaky(x*scale - shift), applied once per staged element; the
//         padding stays zero after it;
//   CORR  g = gy + gs[0] + 2*y*gs[1], built once per staged element.
// The JAX kernel sums band positions and folds them back into taps after
// (pallas_conv.py:1690-1701); this one sums the taps directly.
//
// What bounds it on the H100: memory, nearly. A dW value takes 2*N*Vo FLOPs
// (Vo output voxels per sample); the input is read once, 8 voxels per
// output voxel: at 32 -> 64 from 128^3, N=2, 58 GFLOP against 0.34-0.40 GB
// (0.059 ms of bf16 peak, 0.10-0.12 ms of HBM).
//
// Design: conv3d_k3_dw_s1.cu's 27 GEMMs, dW[k] (Ci x Co) = X_k^T G with K
// the output voxels, on mma.sync.m16n8k16 (T in, fp32 accumulate), with
// the input staged by parity as in conv3d_k3_s2.cu.
//   Tiles. A block owns all 27 taps of a 32 ci x 32 co tile: 9 warps, one
//     per (kd, kh), each holding the three kw taps' 32 x 32 sums (96 fp32
//     registers a thread), over the range of output bricks it is given.
//   Loads. The K loop runs over bricks of 2 x 8 x 8 = 128 output voxels.
//     For each the block stages, with cp.async into a 2-stage ring, the
//     brick's input footprint (5 x 17 x 17 voxels x 32 channels, zero
//     outside the volume) split by parity into 8 sub-bricks (the layout of
//     conv3d_k3_s2.cu and ops/conv3d.py s2_row), the g brick (128 voxels x
//     32 channels) and y's in CORR mode: 92,480 + 8,192 (+ 8,192) bytes a
//     stage. A tap's 8 consecutive output w then read 8 consecutive rows of
//     one sub-brick, so dw_s1's 64-byte rows with quarters permuted by
//     row / 2 and its ldmatrix.trans addressing carry over.
//   Prologues once per element: PRE rewrites the staged footprint in
//     place, CORR the g brick.
//   Deterministic reduction across blocks. The planner (ops/conv3d.py
//     _dw_s2_plan) cuts the bricks into `splits` ranges so that tiles x
//     splits blocks fill the SMs once (66 x 2 at 32 -> 64, 16 x 8 at
//     64 -> 128 on 132 SMs). Each block stores its 27 x 32 x 32 sums to its
//     own slice of an fp32 (splits, 27, Ci, Co) scratch; conv3d_k3_dw_s2_sum
//     adds the slices in split order. No atomics: two runs on the same
//     inputs give bit-equal dW.
//
// Requirements (checked by the wrapper and here): Ci % 32 == 0,
// Co % 32 == 0, contiguous 16-byte aligned x, gy, y.
//
// T, the operand type, is bf16 or fp16 (b16.cuh); "bf16" below stands
// for T, and the launcher's dtype code picks it.

#include "b16.cuh"

namespace {

constexpr int BD = 2, BH = 8, BW = 8;             // brick of output voxels
constexpr int BV = BD * BH * BW;                  // 128: K per stage
constexpr int FD = 2 * BD + 1, FH = 2 * BH + 1, FW = 2 * BW + 1;
constexpr int ROWS = FD * FH * FW;                // 1445 footprint rows
constexpr int CT = 32;                            // ci and co per tile
constexpr int ROW = CT * 2;                       // 64-byte rows
constexpr int WARPS = 9;
constexpr int THREADS = 32 * WARPS;
constexpr int X_BYTES = ROWS * ROW;               // 92480
constexpr int G_BYTES = BV * ROW;                 // 8192
constexpr int SUM_THREADS = 256;

// rows of a sub-brick along an axis of b outputs: parity 0 (even footprint
// positions) b + 1, parity 1 b
__host__ __device__ constexpr int ext(int b, int p) { return b + 1 - p; }

// staged row of the footprint position (2m_d + p_d, 2m_h + p_h, 2m_w + p_w)
// (conv3d_k3_s2.cu frow)
__device__ __forceinline__ int frow(int pd, int ph, int pw, int md, int mh,
                                    int mw) {
  const int eh = ext(BH, ph), ew = ext(BW, pw);
  const int off = pd * ext(BD, 0) * FH * FW +
                  ext(BD, pd) * (ph * ext(BH, 0) * FW + eh * pw * ext(BW, 0));
  return off + (md * eh + mh) * ew + mw;
}

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

struct Geom {
  int N, D, H, W, Ci, Co;
  int Do, Ho, Wo;       // output extents
  int nbh, nbw, NB;     // output bricks per axis (h, w) and per sample
};

struct Brick {
  int n, d0, h0, w0;    // sample, output brick origin
};

// brick index b = ((n * nbd + bd) * nbh + bh) * nbw + bw, as _dw_s2_plan
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

// the footprint walked in runs along w, as in conv3d_k3_s2.cu: run (rd,
// rh, pw, c) is 16-byte quarter c of the positions rw = 2 mw + pw of one
// (rd, rh) line, consecutive staged rows. f(row, c, inside the volume,
// input voxel) for each.
template <typename F>
__device__ __forceinline__ void for_foot(const Geom& g, const Brick& t, F f) {
  constexpr int RUNS = FD * FH * 2 * 4;
  for (int i = threadIdx.x; i < RUNS; i += THREADS) {
    const int c = i & 3, pw = (i >> 2) & 1, rh = (i >> 3) % FH,
              rd = (i >> 3) / FH;
    const int d = 2 * t.d0 - 1 + rd, h = 2 * t.h0 - 1 + rh;
    const bool dh = d >= 0 && d < g.D && h >= 0 && h < g.H;
    const int row = frow(rd & 1, rh & 1, pw, rd >> 1, rh >> 1, 0);
    int w = 2 * t.w0 - 1 + pw;
    size_t vox = (((size_t)t.n * g.D + d) * g.H + h) * g.W + w;
    for (int mw = 0; mw < ext(BW, pw); ++mw, w += 2, vox += 2)
      f(row + mw, c, dh && w >= 0 && w < g.W, vox);
  }
}

__device__ __forceinline__ bool out_inside(const Geom& g, const Brick& t,
                                           int r, size_t* vox) {
  const int d = t.d0 + r / (BH * BW), h = t.h0 + (r / BW) % BH,
            w = t.w0 + r % BW;
  if (d >= g.Do || h >= g.Ho || w >= g.Wo) return false;
  *vox = (((size_t)t.n * g.Do + d) * g.Ho + h) * g.Wo + w;
  return true;
}

template <class T, bool CORR>
__device__ __forceinline__ void stage_loads(
    const Geom& g, const Brick& t, int ci0, int co0, unsigned char* st,
    const T* __restrict__ x, const T* __restrict__ gy,
    const T* __restrict__ y) {
  const uint32_t xs = smem_u32(st);
  const uint32_t gs = xs + X_BYTES;
  const uint32_t ys = gs + G_BYTES;
  for_foot(g, t, [&](int row, int c, bool in, size_t vox) {
    cp_async16(xs + swz(row, c), x + (in ? vox * g.Ci + ci0 + c * 8 : 0), in);
  });
  for (int i = threadIdx.x; i < 4 * BV; i += THREADS) {
    const int r = i >> 2, c = i & 3;
    size_t vox = 0;
    const bool in = out_inside(g, t, r, &vox);
    const size_t off = in ? vox * g.Co + co0 + c * 8 : 0;
    cp_async16(gs + swz(r, c), gy + off, in);
    if (CORR) cp_async16(ys + swz(r, c), y + off, in);
  }
}

template <class T, bool PRE, bool CORR>
__device__ __forceinline__ void prologues(const Geom& g, const Brick& t,
                                          int ci0, int co0, unsigned char* st,
                                          const float* __restrict__ pre,
                                          const float* __restrict__ gsv,
                                          float slope) {
  if (PRE) {
    const float* sc = pre + (size_t)t.n * 2 * g.Ci + ci0;
    const float* sh = sc + g.Ci;
    for_foot(g, t, [&](int row, int c, bool in, size_t) {
      if (!in) return;
      uint4* p = reinterpret_cast<uint4*>(st + swz(row, c));
      uint4 q = *p;
      b16x2<T>* v = reinterpret_cast<b16x2<T>*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = c * 8 + 2 * j;
        const float2 a = to_f2(v[j]);
        const float u0 = a.x * sc[k] - sh[k], u1 = a.y * sc[k + 1] - sh[k + 1];
        v[j] = pack2<T>(u0 >= 0.f ? u0 : u0 * slope,
                        u1 >= 0.f ? u1 : u1 * slope);
      }
      *p = q;
    });
  }
  if (CORR) {
    const float* gs0 = gsv + (size_t)t.n * 2 * g.Co + co0;
    const float* gs1 = gs0 + g.Co;
    unsigned char* gb = st + X_BYTES;
    for (int i = threadIdx.x; i < 4 * BV; i += THREADS) {
      const int r = i >> 2, c = i & 3;
      size_t vox;
      if (!out_inside(g, t, r, &vox)) continue;
      uint4* p = reinterpret_cast<uint4*>(gb + swz(r, c));
      const uint4 yq = *reinterpret_cast<const uint4*>(gb + G_BYTES + swz(r, c));
      uint4 q = *p;
      b16x2<T>* v = reinterpret_cast<b16x2<T>*>(&q);
      const b16x2<T>* yv = reinterpret_cast<const b16x2<T>*>(&yq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = c * 8 + 2 * j;
        const float2 a = to_f2(v[j]);
        const float2 b = to_f2(yv[j]);
        v[j] = pack2<T>(a.x + gs0[k] + 2.f * b.x * gs1[k],
                        a.y + gs0[k + 1] + 2.f * b.y * gs1[k + 1]);
      }
      *p = q;
    }
  }
}

template <class T, bool PRE, bool CORR>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_k3_dw_s2_mma(const T* __restrict__ x,
                    const T* __restrict__ gy,
                    const float* __restrict__ pre,
                    const T* __restrict__ y,
                    const float* __restrict__ gsv, float* __restrict__ part,
                    Geom g, int splits, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int STAGE = X_BYTES + (CORR ? 2 : 1) * G_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nco = g.Co / CT;
  const int tiles = (g.Ci / CT) * nco;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int ci0 = (tile / nco) * CT, co0 = (tile % nco) * CT;
  const int total = g.N * g.NB;
  const int b0 = (int)((long long)split * total / splits);
  const int b1 = (int)((long long)(split + 1) * total / splits);
  const int iters = b1 - b0;

  // this warp's taps: (kd, kh) = (warp / 3, warp % 3), kw = 0, 1, 2; tap k
  // along an axis reads parity k == 1 at m = o - o0 + (k == 2)
  const int kd = warp / 3, kh = warp % 3;
  const int pd = kd == 1, sd = kd == 2, ph = kh == 1, sh = kh == 2;
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
      stage_loads<T, CORR>(g, decode(g, b0 + s), ci0, co0, smem + s * STAGE, x,
                        gy, y);
    cp_commit();
  }

  for (int it = 0; it < iters; ++it) {
    unsigned char* st = smem + (it & 1) * STAGE;
    const Brick t = decode(g, b0 + it);
    cp_wait1();
    __syncthreads();
    if (PRE || CORR) {
      prologues<T, PRE, CORR>(g, t, ci0, co0, st, pre, gsv, slope);
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
      const int md = line / BH + sd, mh = line % BH + sh;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int xrow = frow(pd, ph, kw == 1, md, mh, r8 + (kw == 2));
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4_t(xs + swz(xrow, 2 * mt + a_c), a[mt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma16816<T>(acc[kw][mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                        b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (it + 2 < iters)
      stage_loads<T, CORR>(g, decode(g, b0 + it + 2), ci0, co0, st, x, gy, y);
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
conv3d_k3_dw_s2_sum(const float* __restrict__ part, float* __restrict__ dw,
                    long long size, int splits) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * size + i];
  dw[i] = s;
}

template <class T, bool P, bool C>
cudaError_t launch(int grid, cudaStream_t st, const void* x, const void* gy,
                   const void* pre, const void* y, const void* gs, void* part,
                   const Geom& g, int splits, float slope) {
  const int smem = 2 * (X_BYTES + (C ? 2 : 1) * G_BYTES);
  cudaError_t e = cudaFuncSetAttribute(
      conv3d_k3_dw_s2_mma<T, P, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  conv3d_k3_dw_s2_mma<T, P, C><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x),
      static_cast<const T*>(gy), static_cast<const float*>(pre),
      static_cast<const T*>(y), static_cast<const float*>(gs),
      static_cast<float*>(part), g, splits, slope);
  return cudaGetLastError();
}

}  // namespace

// Launches dw = conv_backward_weight(x, gy) at stride 2 on `stream` into a
// (27, Ci, Co) fp32 buffer (written, not added to), with the output bricks
// of 2 x 8 x 8 cut into `splits` ranges (ops/conv3d.py _dw_s2_plan):
// (Ci/32) * (Co/32) * splits blocks, each storing its partial sums to its
// slice of part, an fp32 scratch of splits x 27 x Ci x Co. pre may be null;
// y and gs (the correction) come together or are both null. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int conv3d_k3_dw_s2_ndhwc_launch(const void* x, const void* gy,
                                            const void* pre, const void* y,
                                            const void* gs, void* dw,
                                            void* part, int N, int D, int H,
                                            int W, int Ci, int Co, int splits,
                                            float slope, int dtype, void* stream) {
  return b16_dispatch(dtype, [&](auto t) -> int {
    using T = decltype(t);
    if (Ci % CT != 0 || Co % CT != 0 || N < 1 || D < 1 || H < 1 || W < 1 ||
        splits < 1 || (!y) != (!gs) || !part)
      return (int)cudaErrorInvalidValue;
    Geom g;
    g.N = N, g.D = D, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
    g.Do = (D - 1) / 2 + 1, g.Ho = (H - 1) / 2 + 1, g.Wo = (W - 1) / 2 + 1;
    g.nbh = (g.Ho + BH - 1) / BH;
    g.nbw = (g.Wo + BW - 1) / BW;
    g.NB = ((g.Do + BD - 1) / BD) * g.nbh * g.nbw;
    const long long blocks = (long long)(Ci / CT) * (Co / CT) * splits;
    const long long size = 27LL * Ci * Co;
    if (splits > N * g.NB || blocks > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    const int grid = (int)blocks;
    if (pre)
      e = y ? launch<T, true, true>(grid, st, x, gy, pre, y, gs, part, g, splits,
                                 slope)
            : launch<T, true, false>(grid, st, x, gy, pre, y, gs, part, g, splits,
                                  slope);
    else
      e = y ? launch<T, false, true>(grid, st, x, gy, pre, y, gs, part, g, splits,
                                  slope)
            : launch<T, false, false>(grid, st, x, gy, pre, y, gs, part, g, splits,
                                   slope);
    if (e != cudaSuccess) return (int)e;
    conv3d_k3_dw_s2_sum<<<(unsigned)((size + SUM_THREADS - 1) / SUM_THREADS),
                          SUM_THREADS, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(dw), size, splits);
    return (int)cudaGetLastError();
  });
}
