// Stride-2 3x3x3 pad-1 convolution on NDHWC bf16, on the tensor cores, for
// Hopper (sm_90a). Plain C interface, bound with ctypes (ops/conv3d.py
// conv3d_k3 at stride 2).
//
// Replaces the TPU's Pallas kernel
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_s2_fwd_kernel (via
//     _conv3d_s2_packed_impl: conv3d_s2_packed, the encoder's downsampling
//     convs 32->64 and 64->128)
// It computes y[o, co] = sum_{k, ci} xin[2o - 1 + k, ci] * w[k, ci, co] with
// xin zero outside the volume, and the fusions of conv3d_k3_s1.cu:
//   PRE   xin = leaky(x*scale - shift), applied once per staged element; the
//         padding stays zero after it;
//   ADDIN a bf16 tensor added to the fp32 sum;
//   STATS fp32 [sum; sumsq] of the output (after ADDIN, before rounding)
//         per (sample, channel), summed in a fixed order (below).
//
// What bounds it on the H100: both, nearly. An output value takes 2*27*Ci
// FLOPs, and each output voxel reads 8 input voxels: at 32 -> 64 from 128^3,
// N=2, 58 GFLOP against 0.34 GB (0.059 ms of bf16 peak, 0.10 ms of HBM).
//
// Design: conv3d_k3_s1.cu's implicit GEMM (M = output voxels, N = Co,
// K = 27 taps x Ci) on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), fed by
// a 2-stage cp.async ring over chunks of 16 input channels, with the input
// staged by parity.
//   Parity split. The input footprint of an output brick of BD x 8 x 8 is
//     (2BD+1) x 17 x 17 voxels (relative position r = 2(o - o0) + k per
//     axis). It is staged as 8 sub-bricks, one per parity of (rd, rh, rw):
//     along an axis the even positions r = 2m (taps 0 and 2, m = o - o0 and
//     o - o0 + 1) make B + 1 rows, the odd ones r = 2m + 1 (tap 1) B rows.
//     Each tap then reads, for 8 consecutive output w, 8 consecutive rows of
//     one sub-brick, as a stride-1 tap reads 8 consecutive rows of its halo
//     brick, so the s1 kernel's row swizzle (32-byte rows, halves swapped
//     every 4 rows) and per-lane ldmatrix addressing carry over (the JAX
//     kernel takes the same view: _s2_prepare_input, _S2_SEL). The layout
//     is ops/conv3d.py s2_row's, which the CPU tests check.
//   Tiles. A unit is a brick of output voxels of one sample and 32 output
//     channels; each of the 8 warps owns BD lines of 8 voxels (BD / 2
//     16-row MMA tiles) x 32 channels. BD = 4 (256 outputs): the footprint
//     is 2,601 rows, 83 KB a stage, 221,760 B for the ring with the
//     weights, so one block per SM (16 warps of 2 lines each ran slower
//     on an H100 than these 8 of 4). In PRE mode BD = 2 (1,445 rows): the
//     pre-op'd value is kept as hi + lo bf16 (a second, single-buffered
//     footprint) and each tap's two products go to a fresh fragment added
//     in fp32, as in conv3d_k3_s1.cu, whose notes give the reason (the
//     output's statistics).
//   Persistent blocks walk contiguous ranges of units (ops/conv3d.py
//     _s2_plan); the ring flows across unit boundaries.
//   Deterministic statistics. Each warp reduces its unit's [sum; sumsq]
//     over its lanes and stores them to its own slot of an fp32 scratch
//     (units x warps x 64); conv3d_k3_s2_stats adds the slots of each
//     (sample, channel) in a fixed order. No atomics: two runs on the same
//     inputs give bit-equal y and stats.
//
// Requirements (checked by the wrapper and here): Ci % 32 == 0,
// Co % 32 == 0, contiguous 16-byte aligned x, w, add_to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BH = 8, BW = 8;                 // output brick (h, w)
constexpr int FH = 2 * BH + 1, FW = 2 * BW + 1;  // footprint (h, w): 17
constexpr int BN = 32;                        // output channels per unit
constexpr int KC = 16;                        // input channels per chunk
constexpr int XROW = KC * 2;                  // 32-byte input rows
constexpr int WROW = BN * 2;                  // 64-byte weight rows
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int W_BYTES = 27 * KC * WROW;       // 27648
constexpr int SLOT = 2 * BN;                  // stats floats per warp, unit
constexpr int FIN_THREADS = 1024;

template <int BD>
struct Tile {
  static constexpr int FD = 2 * BD + 1;
  static constexpr int ROWS = FD * FH * FW;   // 2601 (BD 4), 1445 (BD 2)
  static constexpr int X_BYTES = ROWS * XROW;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int MT = BD / 2;           // 16-row MMA tiles a warp
};

// rows of a sub-brick along an axis of b outputs: parity 0 (even footprint
// positions) b + 1, parity 1 b
__host__ __device__ constexpr int ext(int b, int p) { return b + 1 - p; }

// staged row of the footprint position (2m_d + p_d, 2m_h + p_h, 2m_w + p_w):
// the 8 sub-bricks (p_d, p_h, p_w) in that order, each (d, h, w) row-major
template <int BD>
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

// byte offsets of 16-byte piece `c` of staged row `r` (the swizzles)
__device__ __forceinline__ uint32_t swx(int r, int c) {
  return r * XROW + ((c ^ (r >> 2)) & 1) * 16;
}
__device__ __forceinline__ uint32_t sww(int r, int c) {
  return r * WROW + ((c ^ (r >> 1)) & 3) * 16;
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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
  int Do, Ho, Wo;       // output extents
  int nbh, nbw, NB;     // bricks per axis (h, w) and per sample
  int NT, cps;          // output channel tiles, Ci chunks
};

struct Unit {
  int n, co0, d0, h0, w0;  // sample, channel tile, output brick origin
};

// unit u = (tile * N + n) * NB + brick, brick = (bd * nbh + bh) * nbw + bw,
// as _s2_plan
template <int BD>
__device__ __forceinline__ Unit decode(const Geom& g, int u) {
  Unit t;
  int b = u % g.NB;
  const int r = u / g.NB;
  t.n = r % g.N;
  t.co0 = (r / g.N) * BN;
  t.w0 = (b % g.nbw) * BW;
  b /= g.nbw;
  t.h0 = (b % g.nbh) * BH;
  t.d0 = (b / g.nbh) * BD;
  return t;
}

// the footprint walked in runs along w: run (rd, rh, pw, c) is 16-byte
// piece c of the positions rw = 2 mw + pw of one (rd, rh) line, which are
// consecutive staged rows. f(row, c, inside the volume, input voxel) for
// each; d and h are checked once per run, the voxel stepped along w.
template <int BD, typename F>
__device__ __forceinline__ void for_foot(const Geom& g, const Unit& t, F f) {
  constexpr int RUNS = (2 * BD + 1) * FH * 2 * 2;
  for (int i = threadIdx.x; i < RUNS; i += THREADS) {
    const int c = i & 1, pw = (i >> 1) & 1, rh = (i >> 2) % FH,
              rd = (i >> 2) / FH;
    const int d = 2 * t.d0 - 1 + rd, h = 2 * t.h0 - 1 + rh;
    const bool dh = d >= 0 && d < g.D && h >= 0 && h < g.H;
    const int row = frow<BD>(rd & 1, rh & 1, pw, rd >> 1, rh >> 1, 0);
    int w = 2 * t.w0 - 1 + pw;
    size_t vox = (((size_t)t.n * g.D + d) * g.H + h) * g.W + w;
    for (int mw = 0; mw < ext(BW, pw); ++mw, w += 2, vox += 2)
      f(row + mw, c, dh && w >= 0 && w < g.W, vox);
  }
}

template <int BD>
__device__ __forceinline__ void stage_loads(
    const Geom& g, const Unit& t, int chunk, unsigned char* st,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w) {
  const int ci0 = chunk * KC;
  const uint32_t xs = smem_u32(st);
  const uint32_t ws = xs + Tile<BD>::X_BYTES;
  for_foot<BD>(g, t, [&](int row, int c, bool in, size_t vox) {
    cp_async16(xs + swx(row, c), x + (in ? vox * g.Ci + ci0 + c * 8 : 0), in);
  });
  for (int i = threadIdx.x; i < 4 * 27 * KC; i += THREADS) {
    const int r = i >> 2, c = i & 3;  // r = tap * KC + input channel
    cp_async16(ws + sww(r, c),
               w + ((size_t)(r / KC) * g.Ci + ci0 + r % KC) * g.Co + t.co0 +
                   c * 8,
               true);
  }
}

// xin = leaky(x*scale - shift) on the staged footprint, inside the volume
// (the zero padding stays zero): hi = bf16(xin) in place, lo = bf16(xin -
// hi) into the footprint `lo` (zero outside the volume)
template <int BD>
__device__ __forceinline__ void pre_op(const Geom& g, const Unit& t,
                                       int chunk, unsigned char* st,
                                       unsigned char* lo,
                                       const float* __restrict__ pre,
                                       float slope) {
  const float* sc = pre + (size_t)t.n * 2 * g.Ci + chunk * KC;
  const float* sh = sc + g.Ci;
  for_foot<BD>(g, t, [&](int row, int c, bool in, size_t) {
    uint4* lp = reinterpret_cast<uint4*>(lo + swx(row, c));
    if (!in) {
      *lp = make_uint4(0u, 0u, 0u, 0u);
      return;
    }
    uint4* p = reinterpret_cast<uint4*>(st + swx(row, c));
    uint4 q = *p, ql;
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&q);
    __nv_bfloat162* vl = reinterpret_cast<__nv_bfloat162*>(&ql);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = c * 8 + 2 * j;
      const float2 a = __bfloat1622float2(v[j]);
      float u0 = a.x * sc[k] - sh[k], u1 = a.y * sc[k + 1] - sh[k + 1];
      u0 = u0 >= 0.f ? u0 : u0 * slope;
      u1 = u1 >= 0.f ? u1 : u1 * slope;
      v[j] = __floats2bfloat162_rn(u0, u1);
      const float2 h = __bfloat1622float2(v[j]);
      vl[j] = __floats2bfloat162_rn(u0 - h.x, u1 - h.y);
    }
    *p = q;
    *lp = ql;
  });
}

template <int BD, bool PRE, bool STATS, bool ADDIN>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_k3_s2_mma(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ pre,
                 const __nv_bfloat16* __restrict__ add_to,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                 Geom g, int units, float slope) {
  using T = Tile<BD>;
  constexpr int MT = T::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int iters = (u1 - u0) * g.cps;
  if (iters <= 0) return;

  // per-lane ldmatrix coordinates. A (footprint rows): matrices q = (line
  // q & 1 of the tile, k half q >> 1); B (weights, transposed): matrices
  // q = (k half q & 1, column half q >> 1)
  const int q = lane >> 3, r8 = lane & 7;
  int a_od[MT], a_oh[MT];  // this lane's A output row (d, h) in the brick
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int line = BD * warp + 2 * mt + (q & 1);
    a_od[mt] = line / BH;
    a_oh[mt] = line % BH;
  }
  const int a_half = q >> 1;
  const int b_row = 8 * (q & 1) + r8, b_half = q >> 1;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // prologue: the first two stages
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < iters)
      stage_loads<BD>(g, decode<BD>(g, u0 + s / g.cps), s % g.cps,
                      smem + s * T::STAGE, x, w);
    cp_commit();
  }

  for (int it = 0; it < iters; ++it) {
    unsigned char* st = smem + (it & 1) * T::STAGE;
    const int u = u0 + it / g.cps, chunk = it % g.cps;
    const Unit t = decode<BD>(g, u);
    cp_wait1();
    __syncthreads();
    if (PRE) {
      pre_op<BD>(g, t, chunk, st, smem + 2 * T::STAGE, pre, slope);
      __syncthreads();
    }
    const uint32_t xs = smem_u32(st);
    const uint32_t ws = xs + T::X_BYTES;
    const uint32_t ls = smem_u32(smem + 2 * T::STAGE);
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      // tap k along an axis reads parity k == 1 at m = o - o0 + (k == 2)
      const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      uint32_t a[MT][4], b[2][4];
      int arow[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        arow[mt] = frow<BD>(kd == 1, kh == 1, kw == 1, a_od[mt] + (kd == 2),
                            a_oh[mt] + (kh == 2), r8 + (kw == 2));
        ldsm_x4(xs + swx(arow[mt], a_half), a[mt]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_t(ws + sww(tap * KC + b_row, 2 * j + b_half), b[j]);
      if (!PRE) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma16816(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                     b[nt >> 1][(nt & 1) * 2 + 1]);
        continue;
      }
      // PRE: the tap's hi and lo products go to a fresh fragment, added to
      // the sum in fp32
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t lo[4];
        ldsm_x4(ls + swx(arow[mt], a_half), lo);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(p, a[mt], b[nt >> 1][(nt & 1) * 2],
                   b[nt >> 1][(nt & 1) * 2 + 1]);
          mma16816(p, lo, b[nt >> 1][(nt & 1) * 2],
                   b[nt >> 1][(nt & 1) * 2 + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
        }
      }
    }

    if (chunk == g.cps - 1) {
      // epilogue of unit u: rows g and g + 8 of each 16-row tile are lines
      // BD*warp + 2*mt + {0, 1} at w = lane / 4; columns 2*(lane % 4) +
      // {0, 1}
      const int gr = lane >> 2, tc = 2 * (lane & 3);
      float ssum[4][2], qsum[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ssum[j][0] = ssum[j][1] = qsum[j][0] = qsum[j][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          const int line = BD * warp + 2 * mt + hv;
          const int d = t.d0 + line / BH, h = t.h0 + line % BH, xw = t.w0 + gr;
          if (d >= g.Do || h >= g.Ho || xw >= g.Wo) continue;
          const size_t off =
              ((((size_t)t.n * g.Do + d) * g.Ho + h) * g.Wo + xw) * g.Co +
              t.co0;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int co = nt * 8 + tc;
            float v0 = acc[mt][nt][2 * hv], v1 = acc[mt][nt][2 * hv + 1];
            if (ADDIN) {
              const float2 av = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(add_to + off + co));
              v0 += av.x;
              v1 += av.y;
            }
            if (STATS) {
              ssum[nt][0] += v0;
              ssum[nt][1] += v1;
              qsum[nt][0] += v0 * v0;
              qsum[nt][1] += v1 * v1;
            }
            *reinterpret_cast<__nv_bfloat162*>(y + off + co) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      if (STATS) {
        // this warp's [sum; sumsq] of unit u into its own slot
        float* slot = part + ((size_t)u * WARPS + warp) * SLOT;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = ssum[nt][e], qv = qsum[nt][e];
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              s += __shfl_xor_sync(0xffffffffu, s, m);
              qv += __shfl_xor_sync(0xffffffffu, qv, m);
            }
            if (lane < 4) {
              slot[nt * 8 + tc + e] = s;
              slot[BN + nt * 8 + tc + e] = qv;
            }
          }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (it + 2 < iters) {
      const int nx = it + 2;
      stage_loads<BD>(g, decode<BD>(g, u0 + nx / g.cps), nx % g.cps, st, x,
                      w);
    }
    cp_commit();
  }
}

// stats[n, 0 / 1, tile * 32 + c] = the sum over the sample's bricks b and
// warps of part[((tile * N + n) * NB + b) * warps + warp][0 / 1 * 32 + c]:
// one block per (tile, sample), each thread summing every 16th slot of one
// column, then the 16 partial sums in order
__global__ void __launch_bounds__(FIN_THREADS)
conv3d_k3_s2_stats(const float* __restrict__ part, float* __restrict__ stats,
                   int N, int NB, int warps, int Co) {
  constexpr int GROUPS = FIN_THREADS / SLOT;
  __shared__ float red[GROUPS][SLOT];
  const int n = blockIdx.x % N, tile = blockIdx.x / N;
  const int col = threadIdx.x % SLOT, grp = threadIdx.x / SLOT;
  const long long slots = (long long)NB * warps;
  const float* p = part + (size_t)(tile * N + n) * slots * SLOT + col;
  float s = 0.f;
  for (long long r = grp; r < slots; r += GROUPS) s += p[r * SLOT];
  red[grp][col] = s;
  __syncthreads();
  if (threadIdx.x < SLOT) {
    float t = 0.f;
    for (int k = 0; k < GROUPS; ++k) t += red[k][col];
    stats[((size_t)n * 2 + col / BN) * Co + tile * BN + col % BN] = t;
  }
}

struct Args {
  const void *x, *w, *pre, *add_to;
  void *y, *part;
  float slope;
};

template <int BD, bool P, bool ST, bool A>
cudaError_t launch_main(int grid, cudaStream_t st, const Args& a,
                        const Geom& g, int units) {
  const int smem = 2 * Tile<BD>::STAGE + (P ? Tile<BD>::X_BYTES : 0);
  cudaError_t e = cudaFuncSetAttribute(
      conv3d_k3_s2_mma<BD, P, ST, A>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  conv3d_k3_s2_mma<BD, P, ST, A><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const __nv_bfloat16*>(a.w),
      static_cast<const float*>(a.pre),
      static_cast<const __nv_bfloat16*>(a.add_to),
      static_cast<__nv_bfloat16*>(a.y), static_cast<float*>(a.part), g, units,
      a.slope);
  return cudaGetLastError();
}

template <int BD, bool P>
cudaError_t launch_mode(int key, int grid, cudaStream_t st, const Args& a,
                        const Geom& g, int units) {
  switch (key) {
    case 0: return launch_main<BD, P, false, false>(grid, st, a, g, units);
    case 1: return launch_main<BD, P, false, true>(grid, st, a, g, units);
    case 2: return launch_main<BD, P, true, false>(grid, st, a, g, units);
    default: return launch_main<BD, P, true, true>(grid, st, a, g, units);
  }
}

}  // namespace

// Launches y = conv(x, w) at stride 2 on `stream` over `grid` persistent
// blocks (ops/conv3d.py _s2_plan). pre / add_to may be null when their mode
// is off. With stats, part is an fp32 scratch of units x warps x 64 floats
// (units = Co/32 x N x bricks of 4 x 8 x 8 output voxels, 2 x 8 x 8 with
// pre; 8 warps), and stats (N, 2, Co) is written, not added to; both null
// without.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int conv3d_k3_s2_ndhwc_launch(const void* x, const void* w,
                                         const void* pre, const void* add_to,
                                         void* y, void* stats, void* part,
                                         int N, int D, int H, int W, int Ci,
                                         int Co, int grid, float slope,
                                         void* stream) {
  if (Ci % (2 * KC) != 0 || Co % BN != 0 || N < 1 || D < 1 || H < 1 ||
      W < 1 || grid < 1 || (stats == nullptr) != (part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int BD = pre ? 2 : 4;
  Geom g;
  g.N = N, g.D = D, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
  g.Do = (D - 1) / 2 + 1, g.Ho = (H - 1) / 2 + 1, g.Wo = (W - 1) / 2 + 1;
  const int nbd = (g.Do + BD - 1) / BD;
  g.nbh = (g.Ho + BH - 1) / BH;
  g.nbw = (g.Wo + BW - 1) / BW;
  g.NB = nbd * g.nbh * g.nbw;
  g.NT = Co / BN;
  g.cps = Ci / KC;
  const long long units = (long long)g.NT * N * g.NB;
  if (units * WARPS * SLOT > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (grid > units) grid = (int)units;
  const Args a{x, w, pre, add_to, y, part, slope};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = (stats ? 2 : 0) | (add_to ? 1 : 0);
  cudaError_t e = pre ? launch_mode<2, true>(key, grid, st, a, g, (int)units)
                      : launch_mode<4, false>(key, grid, st, a, g,
                                              (int)units);
  if (e != cudaSuccess || !stats) return (int)e;
  conv3d_k3_s2_stats<<<N * g.NT, FIN_THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(stats), N, g.NB,
      WARPS, Co);
  return (int)cudaGetLastError();
}
