// Stride-1 3x3x3 pad-1 convolution on NDHWC bf16, on the tensor cores, for
// Hopper (sm_90a). Plain C interface, bound with ctypes (ops/conv3d.py
// conv3d_k3 at stride 1). The stride-2 forward, conv3d_k3_s2.cu, shares this
// design with its input staged by parity.
//
// Replaces the TPU's Pallas kernel
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_conv_kernel (stride 1, via
//     _conv3d_banded_packed_f: conv3d_packed / _stats / _ns / _dual_stats)
// It computes y[o, co] = sum_{k, ci} xin[o - 1 + k, ci] * w[k, ci, co] with
// xin zero outside the volume, and the TPU kernel's fusions:
//   PRE   xin = leaky(x*scale - shift), the producer's instance norm +
//         LeakyReLU, applied once per staged element; the padding stays zero
//         after it (pallas_conv.py _tile_norm);
//   ADDIN a second conv's bf16 output added to the fp32 sum (the decoder's
//         split-weight skip concat, conv3d_packed_dual_stats);
//   STATS fp32 [sum; sumsq] of the output (after ADDIN, before rounding)
//         per (sample, channel), summed in a fixed order (below).
//
// What bounds it on the H100: the tensor cores. An output value takes
// 2*27*Ci FLOPs and a few bytes (at 128^3 x 32 -> 32, N=2: 232 GFLOP against
// 0.54 GB, 0.235 ms of bf16 peak against 0.16 ms of HBM).
//
// Design: an implicit GEMM, M = output voxels, N = Co, K = 27 taps x Ci,
// on mma.sync.m16n8k16 (T in, fp32 accumulate).
//   Tiles. A unit is a brick of 4 x 8 x 8 = 256 output voxels of one sample
//     and 32 output channels; each of the 8 warps owns 4 lines of 8 voxels
//     (two 16-row MMA tiles) x 32 channels (four 8-column tiles).
//   Loads. The K loop runs over chunks of 16 input channels. For each chunk
//     the block stages, with cp.async into a 2-stage ring, the halo'd input
//     brick (6 x 10 x 10 voxels x 16 channels, zero-filled outside the
//     volume) and the 27 taps' weights for those 16 channels and the unit's
//     32 output channels; the next chunk's copies run while this one's
//     products do. Input rows are 32 bytes with their two halves swapped
//     every 4 rows, weight rows 64 bytes with their quarters permuted by
//     row / 2, so the 8 rows of any ldmatrix phase hit 8 distinct bank
//     groups.
//   Pre-op once per element. In PRE mode the block rewrites the staged
//     brick in place (rows outside the volume left 0), then all 27 taps
//     read it; the direct kernel this replaces recomputed it per tap. The
//     pre-op'd value v is kept as two bf16 numbers, hi = bf16(v) in the
//     brick and lo = bf16(v - hi) in a second, single-buffered brick, and
//     each tap multiplies both: the sum then carries v to ~2^-17 instead of
//     bf16's 2^-9, which the output's [sum; sumsq] need (on an H100,
//     rounding v alone moved them by up to 8e-3 of their scale, the plain
//     fp32 path's limit being 1e-3). PRE mode so does twice the MMAs. Its
//     inputs are mostly positive, so the output's sum is far from 0, and
//     there the tensor cores' fp32 accumulation, which truncates, biases
//     it: on an H100 a chain of 216 MMAs into one accumulator (64
//     channels) moved [sum] by 1e-4 to 2e-3 of its scale against an fp64
//     conv. So in PRE mode each tap's two products start from a zero
//     fragment that is then added to the sum with fp32 adds.
//   Products. A fragments come from the brick at each tap's shifted rows
//     (ldmatrix takes a row address per lane, so a shift costs nothing); B
//     fragments are the tap's weights w[k, ci, co] (rows ci, co contiguous),
//     transposed by ldmatrix.trans into the "col" operand of mma.sync.
//   Persistent blocks. A block walks a contiguous range of units, and its
//     ring flows across unit boundaries, so one unit's epilogue overlaps the
//     next unit's loads.
//   Epilogue. Direct mode adds ADDIN, writes bf16 y and keeps [sum; sumsq]
//     in registers until the group (sample, channel tile) changes or the
//     block's range ends, then reduces over the warp's lanes and stores
//     them to a slot of an fp32 scratch: the flush at a group's last unit
//     to slot `group`, a block's flush at its last unit inside a group to
//     slot groups + block, 8 warps x 64 floats a slot ((groups + grid) x 2 KB
//     in all, 0.54 MB at 128^3 x 32 -> 32, N=2). conv3d_k3_s1_stats adds, per
//     group, the slots of the blocks that ended inside it (a contiguous
//     range) in a fixed order, then the group's own slot.
//   Small shapes. Where the units of an unsplit K (bricks x channel tiles)
//     are fewer than two per SM (16^3 x 256, 8^3 and 4^3 x 512: 256, 64 and
//     32 units on 132 SMs), the planner (ops/conv3d.py _s1_plan) splits K
//     across blocks: each of `splits` units of a brick and tile takes an
//     equal range of the Ci chunks with all 27 taps, so every staged brick
//     still feeds 27 taps. Each split stores its fp32 partials to its own
//     slice of a (splits, N*D*H*W, Co) scratch (8.4 MB a split at 16^3 x
//     256, 2.1 MB at 8^3 x 512, 0.26 MB at 4^3 x 512, N=2: 2, 8 and 16
//     splits), and conv3d_k3_s1_finish adds the slices in split order,
//     adds ADDIN and rounds to bf16; with STATS each finish block stores
//     its [sum; sumsq] per channel (its rows added in order) to a slot, and
//     conv3d_k3_s1_fstats adds the slots in block order.
//   Determinism. No sum uses atomics: two runs on the same inputs give
//     bit-equal y and stats.
// mma.sync rather than wgmma: a tap's A rows are the brick's rows shifted by
// the tap, which no canonical wgmma shared-memory layout describes; ldmatrix
// with per-lane row addresses does.
//
// Requirements (checked by the wrapper and here): Ci % 32 == 0,
// Co % 32 == 0, contiguous 16-byte aligned x, w, add_to; Co <= 2048 where
// K is split.
//
// T, the operand type, is bf16 or fp16 (b16.cuh); "bf16" below stands
// for T, and the launcher's dtype code picks it.

#include "b16.cuh"

namespace {

constexpr int BD = 4, BH = 8, BW = 8;                 // brick of outputs
constexpr int HD = BD + 2, HH = BH + 2, HW = BW + 2;  // halo'd input brick
constexpr int HALO = HD * HH * HW;                    // 600 rows
constexpr int BN = 32;                                // outputs per unit
constexpr int KC = 16;                                // Ci per chunk
constexpr int XROW = KC * 2;                          // 32-byte input rows
constexpr int WROW = BN * 2;                          // 64-byte weight rows
constexpr int THREADS = 256;
constexpr int X_BYTES = HALO * XROW;                  // 19200
constexpr int W_BYTES = 27 * KC * WROW;               // 27648
constexpr int STAGE = X_BYTES + W_BYTES;  // one ring stage; PRE adds X_BYTES
constexpr int WARPS = THREADS / 32;
constexpr int SLOT = 2 * BN;                          // stats floats a warp
constexpr int STAT_THREADS = 1024;
constexpr int FIN_VOX = 64;                           // finish: voxels/block

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

struct Geom {
  int N, D, H, W, Ci, Co;
  int nbh, nbw, NB;     // bricks per axis (h, w) and per sample
  int NT, cps;          // output channel tiles, Ci chunks per unit
  int groups;           // (channel tile, sample) groups: NT * N
  long long slice;      // floats of one split's slice: N * D * H * W * Co
};

struct Unit {
  int n, co0, c0, d0, h0, w0;  // sample, channel tile, first chunk, origin
};

// unit u = ((split * NT + tile) * N + n) * NB + brick, as _s1_plan
__device__ __forceinline__ Unit decode(const Geom& g, int u) {
  Unit t;
  int b = u % g.NB;
  int r = u / g.NB;
  t.n = r % g.N;
  r /= g.N;
  t.co0 = (r % g.NT) * BN;
  t.c0 = (r / g.NT) * g.cps;
  t.w0 = (b % g.nbw) * BW;
  b /= g.nbw;
  t.h0 = (b % g.nbh) * BH;
  t.d0 = (b / g.nbh) * BD;
  return t;
}

__device__ __forceinline__ bool halo_inside(const Geom& g, const Unit& t,
                                            int r, size_t* vox) {
  const int d = t.d0 - 1 + r / (HH * HW), h = t.h0 - 1 + (r / HW) % HH,
            w = t.w0 - 1 + r % HW;
  if (d < 0 || d >= g.D || h < 0 || h >= g.H || w < 0 || w >= g.W)
    return false;
  *vox = (((size_t)t.n * g.D + d) * g.H + h) * g.W + w;
  return true;
}

template <class T>
__device__ __forceinline__ void stage_loads(
    const Geom& g, const Unit& t, int chunk, unsigned char* st,
    const T* __restrict__ x, const T* __restrict__ w) {
  const int ci0 = chunk * KC;
  const uint32_t xs = smem_u32(st);
  const uint32_t ws = xs + X_BYTES;
  for (int i = threadIdx.x; i < 2 * HALO; i += THREADS) {
    const int r = i >> 1, c = i & 1;
    size_t vox = 0;
    const bool in = halo_inside(g, t, r, &vox);
    cp_async16(xs + swx(r, c), x + (in ? vox * g.Ci + ci0 + c * 8 : 0), in);
  }
  for (int i = threadIdx.x; i < 4 * 27 * KC; i += THREADS) {
    const int r = i >> 2, c = i & 3;  // r = tap * KC + input channel
    cp_async16(ws + sww(r, c),
               w + ((size_t)(r / KC) * g.Ci + ci0 + r % KC) * g.Co + t.co0 +
                   c * 8,
               true);
  }
}

// xin = leaky(x*scale - shift) on the staged brick, inside the volume (the
// zero padding stays zero): hi = bf16(xin) in place, lo = bf16(xin - hi)
// into the brick `lo` (zero outside the volume)
template <class T>
__device__ __forceinline__ void pre_op(const Geom& g, const Unit& t, int chunk,
                                       unsigned char* st, unsigned char* lo,
                                       const float* __restrict__ pre,
                                       float slope) {
  const float* sc = pre + (size_t)t.n * 2 * g.Ci + chunk * KC;
  const float* sh = sc + g.Ci;
  for (int i = threadIdx.x; i < 2 * HALO; i += THREADS) {
    const int r = i >> 1, c = i & 1;
    uint4* lp = reinterpret_cast<uint4*>(lo + swx(r, c));
    size_t vox;
    if (!halo_inside(g, t, r, &vox)) {
      *lp = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    uint4* p = reinterpret_cast<uint4*>(st + swx(r, c));
    uint4 q = *p, ql;
    b16x2<T>* v = reinterpret_cast<b16x2<T>*>(&q);
    b16x2<T>* vl = reinterpret_cast<b16x2<T>*>(&ql);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = c * 8 + 2 * j;
      const float2 a = to_f2(v[j]);
      float u0 = a.x * sc[k] - sh[k], u1 = a.y * sc[k + 1] - sh[k + 1];
      u0 = u0 >= 0.f ? u0 : u0 * slope;
      u1 = u1 >= 0.f ? u1 : u1 * slope;
      v[j] = pack2<T>(u0, u1);
      const float2 h = to_f2(v[j]);
      vl[j] = pack2<T>(u0 - h.x, u1 - h.y);
    }
    *p = q;
    *lp = ql;
  }
}

template <class T, bool PRE, bool STATS, bool ADDIN, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 2)
conv3d_k3_s1_mma(const T* __restrict__ x,
                 const T* __restrict__ w,
                 const float* __restrict__ pre,
                 const T* __restrict__ add_to,
                 T* __restrict__ y, float* __restrict__ part,
                 Geom g, int units, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int iters = (u1 - u0) * g.cps;
  if (iters <= 0) return;

  // per-lane ldmatrix coordinates. A (brick rows): matrices q = (line
  // q & 1 of the tile, k half q >> 1); B (weights, transposed): matrices
  // q = (k half q & 1, column half q >> 1)
  const int q = lane >> 3, r8 = lane & 7;
  int a_base[2];  // brick row of this lane's A row at tap (0, 0, 0)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int line = 4 * warp + 2 * mt + (q & 1);
    a_base[mt] = ((line / BH) * HH + line % BH) * HW + r8;
  }
  const int a_half = q >> 1;
  const int b_row = 8 * (q & 1) + r8, b_half = q >> 1;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float ssum[4][2], qsum[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ssum[j][0] = ssum[j][1] = qsum[j][0] = qsum[j][1] = 0.f;

  // prologue: the first two stages
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < iters) {
      const Unit t = decode(g, u0 + s / g.cps);
      stage_loads(g, t, t.c0 + s % g.cps, smem + s * STAGE, x, w);
    }
    cp_commit();
  }

  for (int it = 0; it < iters; ++it) {
    unsigned char* st = smem + (it & 1) * STAGE;
    const int u = u0 + it / g.cps, chunk_i = it % g.cps;
    const Unit t = decode(g, u);
    cp_wait1();
    __syncthreads();
    if (PRE) {
      pre_op<T>(g, t, t.c0 + chunk_i, st, smem + 2 * STAGE, pre, slope);
      __syncthreads();
    }
    const uint32_t xs = smem_u32(st);
    const uint32_t ws = xs + X_BYTES;
    const uint32_t ls = smem_u32(smem + 2 * STAGE);
#pragma unroll 3
    for (int tap = 0; tap < 27; ++tap) {
      const int toff = (tap / 9) * HH * HW + ((tap / 3) % 3) * HW + tap % 3;
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(xs + swx(a_base[mt] + toff, a_half), a[mt]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_t(ws + sww(tap * KC + b_row, 2 * j + b_half), b[j]);
      if (!PRE) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma16816<T>(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                        b[nt >> 1][(nt & 1) * 2 + 1]);
        continue;
      }
      // PRE: the tap's hi and lo products go to a fresh fragment, added to
      // the sum in fp32 (see the note on the pre-op)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t lo[4];
        ldsm_x4(ls + swx(a_base[mt] + toff, a_half), lo);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816<T>(p, a[mt], b[nt >> 1][(nt & 1) * 2],
                      b[nt >> 1][(nt & 1) * 2 + 1]);
          mma16816<T>(p, lo, b[nt >> 1][(nt & 1) * 2],
                      b[nt >> 1][(nt & 1) * 2 + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
        }
      }
    }

    if (chunk_i == g.cps - 1) {
      // epilogue of unit u: rows g and g + 8 of each 16-row tile are lines
      // 4*warp + 2*mt + {0, 1} at w = lane / 4; columns 2*(lane % 4) + {0, 1}
      const int gr = lane >> 2, tc = 2 * (lane & 3);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          const int line = 4 * warp + 2 * mt + hv;
          const int d = t.d0 + line / BH, h = t.h0 + line % BH, xw = t.w0 + gr;
          if (d >= g.D || h >= g.H || xw >= g.W) continue;
          const size_t off =
              ((((size_t)t.n * g.D + d) * g.H + h) * g.W + xw) * g.Co + t.co0;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int co = nt * 8 + tc;
            float v0 = acc[mt][nt][2 * hv], v1 = acc[mt][nt][2 * hv + 1];
            if (SPLIT) {
              *reinterpret_cast<float2*>(part + (t.c0 / g.cps) * g.slice +
                                         off + co) = make_float2(v0, v1);
              continue;
            }
            if (ADDIN) {
              const float2 av = to_f2(
                  *reinterpret_cast<const b16x2<T>*>(add_to + off + co));
              v0 += av.x;
              v1 += av.y;
            }
            if (STATS) {
              ssum[nt][0] += v0;
              ssum[nt][1] += v1;
              qsum[nt][0] += v0 * v0;
              qsum[nt][1] += v1 * v1;
            }
            *reinterpret_cast<b16x2<T>*>(y + off + co) =
                pack2<T>(v0, v1);
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      // the sums change owner when the brick index wraps (new sample or
      // channel tile) and at the block's last unit
      if (STATS && !SPLIT && (u + 1 == u1 || (u + 1) % g.NB == 0)) {
        const int slot =
            (u + 1) % g.NB == 0 ? u / g.NB : g.groups + (int)blockIdx.x;
        float* sp = part + ((size_t)slot * WARPS + warp) * SLOT;
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
              sp[nt * 8 + tc + e] = s;
              sp[BN + nt * 8 + tc + e] = qv;
            }
            ssum[nt][e] = qsum[nt][e] = 0.f;
          }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (it + 2 < iters) {
      const int nx = it + 2;
      const Unit tn = decode(g, u0 + nx / g.cps);
      stage_loads(g, tn, tn.c0 + nx % g.cps, st, x, w);
    }
    cp_commit();
  }
}

// stats[n, 0 / 1, tile * 32 + c] for group G = tile * N + n: the slots
// groups + b of the blocks b whose last unit lies inside G but not at its
// end (a contiguous range of b, so of slots), then G's own slot. One block
// per group, thread (grp, col) summing every 16th warp row of the range in
// order, then the 16 partial sums and G's slot's warps in order.
__global__ void __launch_bounds__(STAT_THREADS)
conv3d_k3_s1_stats(const float* __restrict__ part, float* __restrict__ stats,
                   int N, int NB, int groups, int units, int grid, int Co) {
  constexpr int GROUPS = STAT_THREADS / SLOT;
  __shared__ float red[GROUPS][SLOT];
  const int G = blockIdx.x;
  const int col = threadIdx.x % SLOT, grp = threadIdx.x / SLOT;
  // block b's last unit is floor((b + 1) units / grid) - 1; the first b
  // whose last unit reaches T is ceil(T grid / units) - 1
  const long long lo = ((long long)G * NB + 1) * grid, hi =
      (long long)(G + 1) * NB * grid;
  const int b0 = (int)((lo + units - 1) / units) - 1;
  const int b1 = (int)((hi + units - 1) / units) - 1;
  const float* p = part + ((size_t)(groups + b0) * WARPS) * SLOT + col;
  const long long rows = (long long)(b1 - b0) * WARPS;
  float s = 0.f;
  for (long long r = grp; r < rows; r += GROUPS) s += p[r * SLOT];
  red[grp][col] = s;
  __syncthreads();
  if (threadIdx.x < SLOT) {
    float t = 0.f;
    for (int k = 0; k < GROUPS; ++k) t += red[k][col];
    for (int w = 0; w < WARPS; ++w)
      t += part[((size_t)G * WARPS + w) * SLOT + col];
    stats[((size_t)(G % N) * 2 + col / BN) * Co + (G / N) * BN + col % BN] =
        t;
  }
}

// split mode: y = bf16(the splits' slices added in split order + ADDIN);
// with STATS the block's [sum; sumsq] per channel (its threads' partial
// sums added in row order) to slot (n, block) of fpart
template <class T, bool STATS, bool ADDIN>
__global__ void __launch_bounds__(THREADS)
conv3d_k3_s1_finish(const float* __restrict__ part,
                    const T* __restrict__ add_to,
                    T* __restrict__ y, float* __restrict__ fpart,
                    long long S, int Co, int splits, long long slice) {
  extern __shared__ float red[];  // [rows][2 Co] in STATS mode
  // thread (row, group): 8 channels c0.. of every rows-th voxel, so its
  // [sum; sumsq] stay in registers (Co <= 8 * THREADS)
  const int n = blockIdx.y, CG = Co / 8, rows = THREADS / CG;
  const int c0 = (threadIdx.x % CG) * 8, row = threadIdx.x / CG;
  const long long v0 = (long long)blockIdx.x * FIN_VOX;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float q[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = row; row < rows && i < FIN_VOX; i += rows) {
    const long long v = v0 + i;
    if (v >= S) break;
    const size_t off = ((size_t)n * S + v) * Co + c0;
    float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < splits; ++k) {
      const float4 p0 = *reinterpret_cast<const float4*>(part + k * slice + off);
      const float4 p1 =
          *reinterpret_cast<const float4*>(part + k * slice + off + 4);
      r[0] += p0.x, r[1] += p0.y, r[2] += p0.z, r[3] += p0.w;
      r[4] += p1.x, r[5] += p1.y, r[6] += p1.z, r[7] += p1.w;
    }
    if (ADDIN) {
      const uint4 aq = *reinterpret_cast<const uint4*>(add_to + off);
      const b16x2<T>* av = reinterpret_cast<const b16x2<T>*>(&aq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = to_f2(av[j]);
        r[2 * j] += a.x;
        r[2 * j + 1] += a.y;
      }
    }
    if (STATS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] += r[j];
        q[j] += r[j] * r[j];
      }
    }
    uint4 out;
    b16x2<T>* o = reinterpret_cast<b16x2<T>*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = pack2<T>(r[2 * j], r[2 * j + 1]);
    *reinterpret_cast<uint4*>(y + off) = out;
  }
  if (STATS) {
    if (row < rows) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[row * 2 * Co + c0 + j] = s[j];
        red[row * 2 * Co + Co + c0 + j] = q[j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * Co; c += THREADS) {
      float t = 0.f;
      for (int k = 0; k < rows; ++k) t += red[k * 2 * Co + c];
      fpart[((size_t)n * gridDim.x + blockIdx.x) * 2 * Co + c] = t;
    }
  }
}

// stats[n, c'] (c' over the 2 Co values) = the finish blocks' slots added
// in block order
__global__ void __launch_bounds__(THREADS)
conv3d_k3_s1_fstats(const float* __restrict__ fpart,
                    float* __restrict__ stats, int N, int nblk, int Co) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N * 2 * Co) return;
  const int n = i / (2 * Co), c = i % (2 * Co);
  float t = 0.f;
  for (int b = 0; b < nblk; ++b)
    t += fpart[((size_t)n * nblk + b) * 2 * Co + c];
  stats[i] = t;
}

struct Args {
  const void *x, *w, *pre, *add_to;
  void *y, *part;
  float slope;
};

template <class T, bool P, bool ST, bool A, bool S>
cudaError_t launch_main(int grid, cudaStream_t st, const Args& a,
                        const Geom& g, int units) {
  const int smem = 2 * STAGE + (P ? X_BYTES : 0);
  cudaError_t e = cudaFuncSetAttribute(
      conv3d_k3_s1_mma<T, P, ST, A, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  conv3d_k3_s1_mma<T, P, ST, A, S><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(a.x),
      static_cast<const T*>(a.w),
      static_cast<const float*>(a.pre),
      static_cast<const T*>(a.add_to),
      static_cast<T*>(a.y), static_cast<float*>(a.part), g, units,
      a.slope);
  return cudaGetLastError();
}

template <class T, bool P>
cudaError_t launch_direct(int key, int grid, cudaStream_t st, const Args& a,
                          const Geom& g, int units) {
  switch (key) {
    case 0: return launch_main<T, P, false, false, false>(grid, st, a, g, units);
    case 1: return launch_main<T, P, false, true, false>(grid, st, a, g, units);
    case 2: return launch_main<T, P, true, false, false>(grid, st, a, g, units);
    default: return launch_main<T, P, true, true, false>(grid, st, a, g, units);
  }
}

template <class T, bool ST, bool A>
cudaError_t launch_finish(dim3 grid, cudaStream_t st, const Args& a,
                          long long S, const Geom& g, int splits) {
  const int rows = THREADS / (g.Co / 8);
  conv3d_k3_s1_finish<T, ST, A>
      <<<grid, THREADS, ST ? rows * 2 * g.Co * sizeof(float) : 0, st>>>(
          static_cast<const float*>(a.part),
          static_cast<const T*>(a.add_to),
          static_cast<T*>(a.y),
          static_cast<float*>(a.part) + splits * g.slice, S, g.Co, splits,
          g.slice);
  return cudaGetLastError();
}

}  // namespace

// Launches y = conv(x, w) at stride 1 on `stream` over `grid` persistent
// blocks, K split into `splits` ranges of Ci chunks (a divisor of Ci / 16;
// ops/conv3d.py _s1_plan chooses both). pre / add_to / stats may be null
// when their mode is off; stats (N, 2, Co) is written, not added to. part
// is an fp32 scratch, null with neither splits > 1 nor stats: with
// splits == 1, (groups + grid) x 8 warps x 64 floats of statistics slots
// (groups = Co / 32 x N); with splits > 1, splits slices of N x D x H x W x
// Co floats, then with stats N x ceil(D*H*W / 64) x 2 x Co floats of the
// finish blocks' slots.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int conv3d_k3_s1_ndhwc_launch(const void* x, const void* w,
                                         const void* pre, const void* add_to,
                                         void* y, void* stats, void* part,
                                         int N, int D, int H, int W, int Ci,
                                         int Co, int splits, int grid,
                                         float slope, int dtype, void* stream) {
  return b16_dispatch(dtype, [&](auto t) -> int {
    using T = decltype(t);
    if (Ci % (2 * KC) != 0 || Co % BN != 0 || N < 1 || D < 1 || H < 1 ||
        W < 1 || splits < 1 || (Ci / KC) % splits != 0 || grid < 1 ||
        (splits > 1 || stats) != (part != nullptr) ||
        (splits > 1 && Co > 8 * THREADS))
      return (int)cudaErrorInvalidValue;
    Geom g;
    g.N = N, g.D = D, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
    const int nbd = (D + BD - 1) / BD;
    g.nbh = (H + BH - 1) / BH;
    g.nbw = (W + BW - 1) / BW;
    g.NB = nbd * g.nbh * g.nbw;
    g.NT = Co / BN;
    g.cps = (Ci / KC) / splits;
    g.groups = g.NT * N;
    const long long S = (long long)D * H * W;
    g.slice = N * S * Co;
    const long long units = (long long)splits * g.NT * N * g.NB;
    if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if (grid > units) grid = (int)units;
    const Args a{x, w, pre, add_to, y, part, slope};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (splits == 1) {
      const int key = (stats ? 2 : 0) | (add_to ? 1 : 0);
      e = pre ? launch_direct<T, true>(key, grid, st, a, g, (int)units)
              : launch_direct<T, false>(key, grid, st, a, g, (int)units);
      if (e != cudaSuccess || !stats) return (int)e;
      conv3d_k3_s1_stats<<<g.groups, STAT_THREADS, 0, st>>>(
          static_cast<const float*>(part), static_cast<float*>(stats), N, g.NB,
          g.groups, (int)units, grid, Co);
      return (int)cudaGetLastError();
    }
    e = pre ? launch_main<T, true, false, false, true>(grid, st, a, g, (int)units)
            : launch_main<T, false, false, false, true>(grid, st, a, g,
                                                     (int)units);
    if (e != cudaSuccess) return (int)e;
    const int nblk = (int)((S + FIN_VOX - 1) / FIN_VOX);
    const dim3 fgrid((unsigned)nblk, N);
    if (stats)
      e = add_to ? launch_finish<T, true, true>(fgrid, st, a, S, g, splits)
                 : launch_finish<T, true, false>(fgrid, st, a, S, g, splits);
    else
      e = add_to ? launch_finish<T, false, true>(fgrid, st, a, S, g, splits)
                 : launch_finish<T, false, false>(fgrid, st, a, S, g, splits);
    if (e != cudaSuccess || !stats) return (int)e;
    conv3d_k3_s1_fstats<<<(N * 2 * Co + THREADS - 1) / THREADS, THREADS, 0,
                          st>>>(
        static_cast<const float*>(part) + splits * g.slice,
        static_cast<float*>(stats), N, nblk, Co);
    return (int)cudaGetLastError();
  });
}
