// Input gradient (dx) of the stride-1 3x3x3 pad-1 convolution on NDHWC bf16,
// on the tensor cores, for Hopper (sm_90a). Plain C interface, bound with
// ctypes (ops/conv3d.py conv3d_k3_dx at stride 1). The stride-2 dx,
// conv3d_k3_dx_s2.cu, shares its operand scheme.
//
// Replaces the TPU's Pallas kernel
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_conv_kernel in its corr/post
//     mode (via _conv3d_dx_fused_f: the backward of conv3d_packed_stats,
//     conv3d_packed_ns and conv3d_packed_dual_stats)
// For the forward y[o] = sum_k x[o - 1 + k] . w[k] it computes
//   dx[i, ci] = sum_{k, co} g[i + 1 - k, co] * w[k, ci, co]
// with g zero outside the volume: the transposed conv, its weights indexed
// in place (no flipped copy of w is written). Fusions kept from the TPU
// kernel:
//   CORR  g = bf16(gy + gs[0] + 2*y*gs[1]), the instance-norm statistics'
//         cotangent folded into the output's, built in fp32 once per staged
//         element and rounded to bf16 as the TPU kernel rounds it before its
//         matrix unit (pallas_conv.py _tile_corr_flat); rows outside the
//         volume stay 0, so the +gs[0] term never reaches the padding. The
//         corrected cotangent is never written to device memory.
//   POST  the backward of the pre-op leaky(x*scale - shift): with the raw
//         input x and pre = [scale; shift], u = x*scale - shift and
//         du = acc * (u >= 0 ? 1 : slope) on the fp32 sum; the kernel writes
//         bf16(du*scale) and [sum du*x; sum du] per (sample, channel) into
//         dst (N, 2, Ci), summed in a fixed order (below).
//
// What bounds it on the H100: the tensor cores, as in the forward. A dx
// value takes 2*27*Co FLOPs and a few bytes (at 128^3 x 32 -> 32, N=2:
// 232 GFLOP against 0.54 GB, 0.235 ms of bf16 peak against 0.16 ms of HBM).
//
// Design: conv3d_k3_s1.cu's implicit GEMM with the roles of x and y
// swapped: M = dx voxels, N = Ci, K = 27 taps x Co, on mma.sync.m16n8k16
// (bf16 in, fp32 accumulate).
//   Tiles. A unit is a brick of 8 x 8 x 8 = 512 dx voxels of one sample and
//     32 dx channels; each of the 16 warps owns 4 lines of 8 voxels (two
//     16-row MMA tiles) x 32 channels (four 8-column tiles).
//   Loads. The K loop runs over chunks of 16 cotangent channels. For each
//     chunk the block stages, with cp.async into a 2-stage ring, the halo'd
//     cotangent brick (10 x 10 x 10 voxels x 16 channels, zero-filled
//     outside the volume), with CORR the matching y brick, and the 27 taps'
//     weights w[k, ci, co] for the unit's 32 ci and the chunk's 16 co; the
//     next chunk's copies run while this one's products do. With CORR the
//     block rewrites the staged gy brick in place into g before any tap
//     reads it. All staged rows are 32 bytes with their two halves swapped
//     every 4 rows (swz), so the 8 rows of any ldmatrix phase hit 8
//     distinct bank groups. A ring stage is 59,648 B (91,648 B with CORR),
//     so one block of 16 warps runs per SM.
//   Products. A fragments come from the brick at each tap's shifted rows
//     (dx voxel l reads brick row l + 2 - k per axis; ldmatrix takes a row
//     address per lane, so a shift costs nothing). B is w[k, ci, co] as it
//     lies: rows ci (N), co (K) contiguous, which is the "col" operand of
//     mma.sync, loaded by ldmatrix without .trans. The 27 taps are unrolled
//     (their shifts and weight rows constants).
//   Measured choices (an H100, against conv3d_k3_s1.cu's shape of 8 warps
//     over 4 x 8 x 8 at two blocks per SM and 3-way unrolled taps, with y
//     in a single buffer loaded after the rewrite): 16 warps over this
//     brick 2-9% faster, with the taps unrolled 10-18% faster again
//     (nothing with POST at 128^3, where the unrolled loop spills), and y
//     staged in the ring beside gy (one barrier less a chunk) 2-5% faster
//     again.
//   Persistent blocks. A block walks a contiguous range of units, and its
//     ring flows across unit boundaries.
//   Epilogue. Plain or CORR: bf16 dx. POST: du and bf16(du*scale) as above,
//     [sum du*x; sum du] kept in registers until the group (sample, channel
//     tile) changes or the block's range ends, then reduced over the warp's
//     lanes and stored to a slot of an fp32 scratch: the flush at a group's
//     last unit to slot `group`, a block's flush at its last unit inside a
//     group to slot groups + block, 16 warps x 64 floats a slot (the layout
//     of conv3d_k3_s1.cu's statistics, ops/conv3d.py s1_stat_slots).
//     conv3d_k3_dx_s1_dst adds, per group, the slots of the blocks that
//     ended inside it in block order, then the group's own slot.
//   Small shapes. Where the units of an unsplit K (bricks x channel tiles)
//     are fewer than the SMs (16^3 x 256, 8^3 and 4^3 x 512: 128, 32 and 32
//     units on 132 SMs), the planner (ops/conv3d.py _dx_s1_plan) splits
//     K across blocks: each of `splits` units of a brick and tile takes an
//     equal range of the Co chunks with all 27 taps. Each split stores its
//     fp32 partials to its own slice of a (splits, N*D*H*W, Ci) scratch, and
//     conv3d_k3_dx_s1_finish adds the slices in split order, applies the
//     POST epilogue to the sum and rounds to bf16; with POST each finish
//     block stores its [sum du*x; sum du] per channel to a slot, and
//     conv3d_k3_dx_s1_fdst adds the slots in block order.
//   Precision. Each accumulator takes one chain of 27 x Co / 16 MMAs, as the
//     forward's plain mode does. Its inputs are signed cotangents, so the
//     tensor cores' truncating fp32 accumulation has no sign to bias.
//   Determinism. No sum uses atomics: two runs on the same inputs give
//     bit-equal dx and dst.
//
// Requirements (checked by the wrapper and here): Ci % 32 == 0,
// Co % 32 == 0, contiguous 16-byte aligned gy, y, x, w; Ci <= 2048 where K
// is split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BD = 8, BH = 8, BW = 8;                 // brick of dx voxels
constexpr int HD = BD + 2, HH = BH + 2, HW = BW + 2;  // halo'd cotangent brick
constexpr int HALO = HD * HH * HW;                    // 1000 rows
constexpr int BN = 32;                                // dx channels per unit
constexpr int KC = 16;                                // Co per chunk
constexpr int ROW = KC * 2;                           // 32-byte staged rows
constexpr int THREADS = 512;
constexpr int G_BYTES = HALO * ROW;                   // 32000
constexpr int W_BYTES = 27 * BN * ROW;                // 27648
constexpr int WARPS = THREADS / 32;
constexpr int SLOT = 2 * BN;                          // dst floats a warp
constexpr int DST_THREADS = 1024;
constexpr int FIN_THREADS = 256;
constexpr int FIN_VOX = 64;                           // finish: voxels/block

// a ring stage: the gy brick, with CORR the y brick, then the weights
template <bool CORR>
__host__ __device__ constexpr int stage_bytes() {
  return (CORR ? 2 : 1) * G_BYTES + W_BYTES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte piece `c` of staged row `r` (the swizzle)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW + ((c ^ (r >> 2)) & 1) * 16;
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

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the pre-op's backward at one element: du = acc * leaky'(x*scale - shift)
// (u rounded as the plain version rounds it, no fused multiply-add)
__device__ __forceinline__ float post_du(float acc, float xv, float sc,
                                         float sh, float slope) {
  const float u = __fsub_rn(__fmul_rn(xv, sc), sh);
  return u >= 0.f ? acc : acc * slope;
}

struct Geom {
  int N, D, H, W, Ci, Co;
  int nbh, nbw, NB;     // bricks per axis (h, w) and per sample
  int NT, cps;          // dx channel tiles, Co chunks per unit
  int groups;           // (channel tile, sample) groups: NT * N
  long long slice;      // floats of one split's slice: N * D * H * W * Ci
};

struct Unit {
  int n, ci0, c0, d0, h0, w0;  // sample, channel tile, first chunk, origin
};

// unit u = ((split * NT + tile) * N + n) * NB + brick, as _dx_s1_plan
__device__ __forceinline__ Unit decode(const Geom& g, int u) {
  Unit t;
  int b = u % g.NB;
  int r = u / g.NB;
  t.n = r % g.N;
  r /= g.N;
  t.ci0 = (r % g.NT) * BN;
  t.c0 = (r / g.NT) * g.cps;
  t.w0 = (b % g.nbw) * BW;
  b /= g.nbw;
  t.h0 = (b % g.nbh) * BH;
  t.d0 = (b / g.nbh) * BD;
  return t;
}

// halo row r is the cotangent voxel (brick origin - 1) + (r_d, r_h, r_w)
__device__ __forceinline__ bool halo_inside(const Geom& g, const Unit& t,
                                            int r, size_t* vox) {
  const int d = t.d0 - 1 + r / (HH * HW), h = t.h0 - 1 + (r / HW) % HH,
            w = t.w0 - 1 + r % HW;
  if (d < 0 || d >= g.D || h < 0 || h >= g.H || w < 0 || w >= g.W)
    return false;
  *vox = (((size_t)t.n * g.D + d) * g.H + h) * g.W + w;
  return true;
}

// the halo'd brick of one chunk of src (gy or y), zero outside the volume
__device__ __forceinline__ void stage_brick(const Geom& g, const Unit& t,
                                            int chunk, uint32_t dst,
                                            const __nv_bfloat16* src) {
  const int co0 = chunk * KC;
  for (int i = threadIdx.x; i < 2 * HALO; i += THREADS) {
    const int r = i >> 1, c = i & 1;
    size_t vox = 0;
    const bool in = halo_inside(g, t, r, &vox);
    cp_async16(dst + swz(r, c), src + (in ? vox * g.Co + co0 + c * 8 : 0),
               in);
  }
}

// the 27 taps' weights of the unit's 32 dx channels and the chunk's 16 co:
// row tap * 32 + ci
__device__ __forceinline__ void stage_weights(const Geom& g, const Unit& t,
                                              int chunk, uint32_t dst,
                                              const __nv_bfloat16* w) {
  const int co0 = chunk * KC;
  for (int i = threadIdx.x; i < 2 * 27 * BN; i += THREADS) {
    const int r = i >> 1, c = i & 1;
    cp_async16(dst + swz(r, c),
               w + ((size_t)(r / BN) * g.Ci + t.ci0 + r % BN) * g.Co + co0 +
                   c * 8,
               true);
  }
}

// CORR: the staged gy brick becomes bf16(gy + gs0 + 2*y*gs1) in place,
// inside the volume only (rows outside stay 0). A thread always handles
// piece tid & 1 of its rows, so it reads its 8 channels' gs once.
__device__ __forceinline__ void correct(const Geom& g, const Unit& t,
                                        int chunk, unsigned char* gb,
                                        const unsigned char* yb,
                                        const float* __restrict__ gs) {
  const int c = threadIdx.x & 1;
  const float* g0p = gs + (size_t)t.n * 2 * g.Co + chunk * KC + c * 8;
  float g0[8], g1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    g0[j] = g0p[j];
    g1[j] = g0p[g.Co + j];
  }
  for (int i = threadIdx.x; i < 2 * HALO; i += THREADS) {
    const int r = i >> 1;
    size_t vox;
    if (!halo_inside(g, t, r, &vox)) continue;
    uint4* p = reinterpret_cast<uint4*>(gb + swz(r, c));
    const uint4 yq = *reinterpret_cast<const uint4*>(yb + swz(r, c));
    uint4 q = *p;
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&q);
    const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&yq);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(v[j]), b = __bfloat1622float2(yv[j]);
      v[j] = __floats2bfloat162_rn(
          __fadd_rn(__fadd_rn(a.x, g0[2 * j]),
                    __fmul_rn(2.f * b.x, g1[2 * j])),
          __fadd_rn(__fadd_rn(a.y, g0[2 * j + 1]),
                    __fmul_rn(2.f * b.y, g1[2 * j + 1])));
    }
    *p = q;
  }
}

struct Args {
  const __nv_bfloat16 *gy, *w, *y, *x;
  const float *gs, *pre;
  __nv_bfloat16* dx;
  float* part;
  float slope;
};

template <bool CORR, bool POST, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_k3_dx_s1_mma(Args a, Geom g, int units) {
  constexpr int STAGE = stage_bytes<CORR>();
  constexpr int W_OFF = STAGE - W_BYTES;  // the weights' offset in a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int iters = (u1 - u0) * g.cps;
  if (iters <= 0) return;

  // per-lane ldmatrix coordinates. A (brick rows): matrices q = (line
  // q & 1 of the tile, k half q >> 1); B (weight rows ci, k = co along the
  // row): matrices q = (k half q & 1, 8-channel tile q >> 1 of the pair)
  const int q = lane >> 3, r8 = lane & 7;
  int a_base[2];  // brick row of this lane's A row at a shift of 0
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int line = 4 * warp + 2 * mt + (q & 1);
    a_base[mt] = ((line / BH) * HH + line % BH) * HW + r8;
  }
  const int a_half = q >> 1;
  const int b_row = 8 * (q >> 1) + r8, b_half = q & 1;

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
      const int chunk = t.c0 + s % g.cps;
      const uint32_t st = smem_u32(smem + s * STAGE);
      stage_brick(g, t, chunk, st, a.gy);
      if (CORR) stage_brick(g, t, chunk, st + G_BYTES, a.y);
      stage_weights(g, t, chunk, st + W_OFF, a.w);
    }
    cp_commit();
  }

  for (int it = 0; it < iters; ++it) {
    unsigned char* st = smem + (it & 1) * STAGE;
    const int u = u0 + it / g.cps, chunk_i = it % g.cps;
    const Unit t = decode(g, u);
    cp_wait1();  // this stage's copies are done; the next stage's may not be
    __syncthreads();
    if (CORR) {
      correct(g, t, t.c0 + chunk_i, st, st + G_BYTES, a.gs);
      __syncthreads();
    }
    const uint32_t gsm = smem_u32(st);
    const uint32_t wsm = gsm + W_OFF;
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      // dx voxel l takes tap k from cotangent row l + 2 - k on each axis
      const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      const int toff = (2 - kd) * HH * HW + (2 - kh) * HW + (2 - kw);
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(gsm + swz(a_base[mt] + toff, a_half), af[mt]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4(wsm + swz(tap * BN + 16 * j + b_row, b_half), bf[j]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma16816(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
                   bf[nt >> 1][(nt & 1) * 2 + 1]);
    }

    if (chunk_i == g.cps - 1) {
      // epilogue of unit u: rows g and g + 8 of each 16-row tile are lines
      // 4*warp + 2*mt + {0, 1} at w = lane / 4; columns 2*(lane % 4) + {0, 1}
      const int gr = lane >> 2, tc = 2 * (lane & 3);
      const float* sc =
          POST ? a.pre + (size_t)t.n * 2 * g.Ci + t.ci0 : a.pre;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          const int line = 4 * warp + 2 * mt + hv;
          const int d = t.d0 + line / BH, h = t.h0 + line % BH, xw = t.w0 + gr;
          if (d >= g.D || h >= g.H || xw >= g.W) continue;
          const size_t off =
              ((((size_t)t.n * g.D + d) * g.H + h) * g.W + xw) * g.Ci + t.ci0;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ci = nt * 8 + tc;
            float v0 = acc[mt][nt][2 * hv], v1 = acc[mt][nt][2 * hv + 1];
            if (SPLIT) {
              *reinterpret_cast<float2*>(a.part + (t.c0 / g.cps) * g.slice +
                                         off + ci) = make_float2(v0, v1);
              continue;
            }
            if (POST) {
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(a.x + off + ci));
              const float du0 = post_du(v0, xv.x, sc[ci], sc[g.Ci + ci],
                                        a.slope);
              const float du1 = post_du(v1, xv.y, sc[ci + 1],
                                        sc[g.Ci + ci + 1], a.slope);
              ssum[nt][0] += du0 * xv.x;
              ssum[nt][1] += du1 * xv.y;
              qsum[nt][0] += du0;
              qsum[nt][1] += du1;
              v0 = du0 * sc[ci];
              v1 = du1 * sc[ci + 1];
            }
            *reinterpret_cast<__nv_bfloat162*>(a.dx + off + ci) =
                __floats2bfloat162_rn(v0, v1);
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
      if (POST && !SPLIT && (u + 1 == u1 || (u + 1) % g.NB == 0)) {
        const int slot =
            (u + 1) % g.NB == 0 ? u / g.NB : g.groups + (int)blockIdx.x;
        float* sp = a.part + ((size_t)slot * WARPS + warp) * SLOT;
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
      const int chunk = tn.c0 + nx % g.cps;
      stage_brick(g, tn, chunk, smem_u32(st), a.gy);
      if (CORR) stage_brick(g, tn, chunk, smem_u32(st) + G_BYTES, a.y);
      stage_weights(g, tn, chunk, smem_u32(st) + W_OFF, a.w);
    }
    cp_commit();
  }
}

// dst[n, 0 / 1, tile * 32 + c] for group G = tile * N + n: the slots
// groups + b of the blocks b whose last unit lies inside G but not at its
// end (a contiguous range of b, so of slots), then G's own slot. One block
// per group, thread (grp, col) summing every 16th warp row of the range in
// order, then the 16 partial sums and G's slot's warps in order.
__global__ void __launch_bounds__(DST_THREADS)
conv3d_k3_dx_s1_dst(const float* __restrict__ part, float* __restrict__ dst,
                    int N, int NB, int groups, int units, int grid, int Ci) {
  constexpr int GROUPS = DST_THREADS / SLOT;
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
    dst[((size_t)(G % N) * 2 + col / BN) * Ci + (G / N) * BN + col % BN] = t;
  }
}

// split mode: dx = bf16(the splits' slices added in split order), with POST
// through the pre-op's backward, and then the block's [sum du*x; sum du]
// per channel (its threads' partial sums added in row order) to slot
// (n, block) of fpart
template <bool POST>
__global__ void __launch_bounds__(FIN_THREADS)
conv3d_k3_dx_s1_finish(Args a, float* __restrict__ fpart, long long S, int Ci,
                       int splits, long long slice) {
  extern __shared__ float red[];  // [rows][2 Ci] in POST mode
  // thread (row, group): 8 channels c0.. of every rows-th voxel, so its
  // sums stay in registers (Ci <= 8 * FIN_THREADS)
  const int n = blockIdx.y, CG = Ci / 8, rows = FIN_THREADS / CG;
  const int c0 = (threadIdx.x % CG) * 8, row = threadIdx.x / CG;
  const long long v0 = (long long)blockIdx.x * FIN_VOX;
  const float* sc = POST ? a.pre + (size_t)n * 2 * Ci + c0 : a.pre;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float q[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = row; row < rows && i < FIN_VOX; i += rows) {
    const long long v = v0 + i;
    if (v >= S) break;
    const size_t off = ((size_t)n * S + v) * Ci + c0;
    float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < splits; ++k) {
      const float4 p0 =
          *reinterpret_cast<const float4*>(a.part + k * slice + off);
      const float4 p1 =
          *reinterpret_cast<const float4*>(a.part + k * slice + off + 4);
      r[0] += p0.x, r[1] += p0.y, r[2] += p0.z, r[3] += p0.w;
      r[4] += p1.x, r[5] += p1.y, r[6] += p1.z, r[7] += p1.w;
    }
    if (POST) {
      const uint4 xq = *reinterpret_cast<const uint4*>(a.x + off);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xf = __bfloat1622float2(xv[j]);
        const float xs[2] = {xf.x, xf.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * j + e;
          const float du = post_du(r[k], xs[e], sc[k], sc[Ci + k], a.slope);
          s[k] += du * xs[e];
          q[k] += du;
          r[k] = du * sc[k];
        }
      }
    }
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = __floats2bfloat162_rn(r[2 * j], r[2 * j + 1]);
    *reinterpret_cast<uint4*>(a.dx + off) = out;
  }
  if (POST) {
    if (row < rows) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[row * 2 * Ci + c0 + j] = s[j];
        red[row * 2 * Ci + Ci + c0 + j] = q[j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * Ci; c += FIN_THREADS) {
      float t = 0.f;
      for (int k = 0; k < rows; ++k) t += red[k * 2 * Ci + c];
      fpart[((size_t)n * gridDim.x + blockIdx.x) * 2 * Ci + c] = t;
    }
  }
}

// dst[n, c'] (c' over the 2 Ci values) = the finish blocks' slots added in
// block order
__global__ void __launch_bounds__(FIN_THREADS)
conv3d_k3_dx_s1_fdst(const float* __restrict__ fpart, float* __restrict__ dst,
                     int N, int nblk, int Ci) {
  const int i = blockIdx.x * FIN_THREADS + threadIdx.x;
  if (i >= N * 2 * Ci) return;
  const int n = i / (2 * Ci), c = i % (2 * Ci);
  float t = 0.f;
  for (int b = 0; b < nblk; ++b)
    t += fpart[((size_t)n * nblk + b) * 2 * Ci + c];
  dst[i] = t;
}

template <bool C, bool P, bool S>
cudaError_t launch_main(int grid, cudaStream_t st, const Args& a,
                        const Geom& g, int units) {
  const int smem = 2 * stage_bytes<C>();
  cudaError_t e = cudaFuncSetAttribute(
      conv3d_k3_dx_s1_mma<C, P, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  conv3d_k3_dx_s1_mma<C, P, S><<<grid, THREADS, smem, st>>>(a, g, units);
  return cudaGetLastError();
}

}  // namespace

// Launches dx = conv_backward_input(gy, w) at stride 1 on `stream` over
// `grid` persistent blocks, K split into `splits` ranges of Co chunks (a
// divisor of Co / 16; ops/conv3d.py _dx_s1_plan chooses both). y and gs
// (CORR) come together or are both null; so do x, pre and dst (POST). dst
// (N, 2, Ci) is written, not added to. part is an fp32 scratch, null with
// neither splits > 1 nor POST: with splits == 1, (groups + grid) x 16
// warps x 64 floats of [sum du*x; sum du] slots (groups = Ci / 32 x N); with
// splits > 1, splits slices of N x D x H x W x Ci floats, then with POST
// N x ceil(D*H*W / 64) x 2 x Ci floats of the finish blocks' slots.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int conv3d_k3_dx_s1_ndhwc_launch(
    const void* gy, const void* w, const void* y, const void* gs,
    const void* x, const void* pre, void* dx, void* dst, void* part, int N,
    int D, int H, int W, int Ci, int Co, int splits, int grid, float slope,
    void* stream) {
  const bool corr = y != nullptr, post = pre != nullptr;
  if (Ci % BN != 0 || Co % (2 * KC) != 0 || N < 1 || N > 65535 || D < 1 ||
      H < 1 || W < 1 || splits < 1 || (Co / KC) % splits != 0 || grid < 1 ||
      corr != (gs != nullptr) || post != (x != nullptr) ||
      post != (dst != nullptr) || (splits > 1 || post) != (part != nullptr) ||
      (splits > 1 && Ci > 8 * FIN_THREADS))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N, g.D = D, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
  const int nbd = (D + BD - 1) / BD;
  g.nbh = (H + BH - 1) / BH;
  g.nbw = (W + BW - 1) / BW;
  g.NB = nbd * g.nbh * g.nbw;
  g.NT = Ci / BN;
  g.cps = (Co / KC) / splits;
  g.groups = g.NT * N;
  const long long S = (long long)D * H * W;
  g.slice = N * S * Ci;
  const long long units = (long long)splits * g.NT * N * g.NB;
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (grid > units) grid = (int)units;
  const Args a{static_cast<const __nv_bfloat16*>(gy),
               static_cast<const __nv_bfloat16*>(w),
               static_cast<const __nv_bfloat16*>(y),
               static_cast<const __nv_bfloat16*>(x),
               static_cast<const float*>(gs),
               static_cast<const float*>(pre),
               static_cast<__nv_bfloat16*>(dx),
               static_cast<float*>(part),
               slope};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (splits == 1) {
    if (corr)
      e = post ? launch_main<true, true, false>(grid, st, a, g, (int)units)
               : launch_main<true, false, false>(grid, st, a, g, (int)units);
    else
      e = post ? launch_main<false, true, false>(grid, st, a, g, (int)units)
               : launch_main<false, false, false>(grid, st, a, g,
                                                  (int)units);
    if (e != cudaSuccess || !post) return (int)e;
    conv3d_k3_dx_s1_dst<<<g.groups, DST_THREADS, 0, st>>>(
        a.part, static_cast<float*>(dst), N, g.NB, g.groups, (int)units,
        grid, Ci);
    return (int)cudaGetLastError();
  }
  e = corr ? launch_main<true, false, true>(grid, st, a, g, (int)units)
           : launch_main<false, false, true>(grid, st, a, g, (int)units);
  if (e != cudaSuccess) return (int)e;
  const int nblk = (int)((S + FIN_VOX - 1) / FIN_VOX);
  const dim3 fgrid((unsigned)nblk, N);
  float* fpart = a.part + splits * g.slice;
  if (post) {
    const int rows = FIN_THREADS / (Ci / 8);
    conv3d_k3_dx_s1_finish<true>
        <<<fgrid, FIN_THREADS, rows * 2 * Ci * sizeof(float), st>>>(
            a, fpart, S, Ci, splits, g.slice);
  } else {
    conv3d_k3_dx_s1_finish<false><<<fgrid, FIN_THREADS, 0, st>>>(
        a, fpart, S, Ci, splits, g.slice);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || !post) return (int)e;
  conv3d_k3_dx_s1_fdst<<<(N * 2 * Ci + FIN_THREADS - 1) / FIN_THREADS,
                         FIN_THREADS, 0, st>>>(fpart, static_cast<float*>(dst),
                                               N, nblk, Ci);
  return (int)cudaGetLastError();
}
