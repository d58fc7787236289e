// 2x2x2 stride-2 transposed convolution (kernel == stride) on NDHWC bf16,
// on the tensor cores, for Hopper (sm_90a). Plain C interface, bound with
// ctypes (ops/upsample.py upsample2x).
//
// Replaces the TPU's Pallas kernel
//   mt3d_resenc_unet_tpu/ops/pallas_upsample.py::_fwd_kernel (via _run_fwd,
//   upsample2x_packed)
// without its lane packing: it computes, with p = (a, b, c) = 4a + 2b + c,
//   y[n, 2i+a, 2j+b, 2k+c, :] = x[n, i, j, k, :] @ Wf[p]
// where Wf is the transposed-conv kernel with its spatial flip already
// applied by the caller (models/network.py UpsampleConv): bf16 operands,
// fp32 sums, one rounding to bf16. As on the TPU, the depth-to-space
// interleave is built into the output write, so no stack or transpose pass
// follows.
//
// What bounds it on the H100: bytes. At the flagship's 128->64 (from 32^3)
// and 64->32 (from 64^3), N=2, it reads x (17 / 67 MB) and writes y (67 /
// 268 MB): 25 / 100 us of HBM, against 8.6 / 17.2 GFLOP, 9 / 17 us of bf16
// tensor-core peak (~51 FLOP per byte, far under the ~295 where the tensor
// cores become the limit). Four fifths of the bytes are y's stores, so the
// design reads each x byte once, writes each y byte once as whole 16-byte
// pieces of contiguous fine rows, and overlaps the loads with the stores.
//
// Design: the mirror image of the backward's dx (upsample2x_bwd.cu), a GEMM
// on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) over coarse-voxel tiles
// of VH x 16 voxels of one (n, d) (ops/upsample.py _up_fwd_plan). A block
// owns TCO output channels of all eight parities, the four (a, b) pairs in
// turn, both c of each, so every x byte it loads serves all of them.
//   A is the tile's x: rows voxels, ci contiguous, so plain ldmatrix loads
//   it. Persistent blocks walk a contiguous range of tiles and stream them
//   through a 2-stage cp.async ring across tiles, so one tile's loads run
//   under the previous tile's products and stores.
//   B is Wf[p] as stored, (Ci, Co) with co contiguous: the transpose of the
//   "col" operand of mma.sync row.col, so ldmatrix.trans loads it.
//   At the flagship's two shapes (CI = Ci, a template argument) all eight
//   parities' weights stay resident (128 KB at 128->64, 32 KB at 64->32),
//   a ring stage is a whole tile's x, and K = Ci runs in one unrolled
//   chain per output (8 or 4 k-steps). Every other Ci (CI = 0) streams in
//   chunks of KC = 32 channels: a ring stage is the tile's x and the
//   current pair's weights for one chunk, so any Ci fits (x is then read
//   once per pair, from L2; no model path runs this case).
//   The 8 warps are 4 along the tile's voxels x 2 along c: a warp's
//   columns are one parity's TCO channels.
// Epilogue, per (a, b): the two c of the tile round to bf16 into shared
//   memory at the rows ops/upsample.py up2_row gives (parity c, coarse
//   voxel v at row c * TM + v: the backward's gy staging read in reverse),
//   XOR-swizzled by row (swz) so that 8 consecutive rows hit 8 distinct
//   bank groups. Then they leave as the contiguous fine-row segments
//   y[n, 2d+a, 2h+b, 2w0 .. 2w0+31, co tile] (4 KB at Co = 64, 2 KB at
//   32), 16 bytes a thread, neighbouring threads on neighbouring bytes.
//   These stores are issued under the next pair's products, a slice per
//   k-step of its first chunk, so that the store stream runs while the
//   tensor cores work (on an H100, 12% faster at 64->32 than storing
//   between the products). Each output is written by exactly one block;
//   there are no atomics.
//
// Requirements (checked by the wrapper and here): Ci % 32 == 0,
// Co % TCO == 0, contiguous 16-byte aligned x, wf, y; the launcher also
// refuses a plan whose shared memory or tile count is not its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VW = 16;      // coarse voxels of a tile along w
constexpr int STAGES = 2;   // x tiles in the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte piece j of row r in rows of P pieces (P % 4 ==
// 0): the piece index is XORed with the row so that 8 consecutive rows
// (from an even row) hit 8 distinct bank groups
__device__ __forceinline__ uint32_t swz(int r, int j, int P) {
  const int s = (P & 7) ? ((j & ~3) | ((j ^ (r >> 1)) & 3))
                        : ((j & ~7) | ((j ^ r) & 7));
  return (uint32_t)(r * P + s) * 16u;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
  int N, D, H, W, Ci, Co;  // coarse extents and channels
  int nhg, nwg;            // tiles along h and w
};

struct Tile {
  int n, d, h0, w0;
};

// tile t = ((n * D + d) * nhg + hg) * nwg + wg, of vh x VW coarse voxels
__device__ __forceinline__ Tile decode(const Geom& g, int t, int vh) {
  Tile r;
  r.w0 = (t % g.nwg) * VW;
  t /= g.nwg;
  r.h0 = (t % g.nhg) * vh;
  t /= g.nhg;
  r.d = t % g.D;
  r.n = t / g.D;
  return r;
}

// CI = Ci where the configuration keeps all its weights resident (its K
// loop unrolled over Ci), else 0: x and the weights stream in K chunks of
// KC channels
template <int TM, int TCO, int CI>
struct FwdCfg {
  static constexpr bool RES = CI != 0;
  static constexpr int KC = RES ? CI : 32;    // channels of a ring stage
  static constexpr int KS = KC / 16;          // k-steps of a ring stage
  static constexpr int VH = TM / VW;
  static constexpr int WTM = TM / 4;          // voxels of a warp's rows
  static constexpr int MT = WTM / 16, NT = TCO / 8;
  static constexpr int PO = TCO / 8;          // pieces of a weight or y row
  static constexpr int PX = KC / 8;           // pieces of a staged x row
  static constexpr int XB = TM * KC * 2;      // a stage's x
  // a stage: x, and where streamed one pair's weights (2 x KC rows)
  static constexpr int STAGE = XB + (RES ? 0 : 2 * KC * TCO * 2);
  static constexpr int WRES = RES ? 8 * CI * TCO * 2 : 0;
  static constexpr int OUT = 2 * TM * TCO * 2;  // staged y of one (a, b)
  static constexpr int SMEM = WRES + STAGES * STAGE + OUT;
  static constexpr int NS = VH * 2 * VW * PO / THREADS;  // stores a thread
  static_assert(MT >= 1 && NT % 2 == 0 && PX % 4 == 0, "warp tile");
  static_assert(NS * THREADS == VH * 2 * VW * PO, "whole stores");
};

template <int TM, int TCO, int CI>
__global__ void __launch_bounds__(THREADS, 1)
upsample2x_ndhwc_mma(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wf,
                     __nv_bfloat16* __restrict__ y, Geom g, int units) {
  using C = FwdCfg<TM, TCO, CI>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Ci = C::RES ? CI : g.Ci;
  const int co0 = blockIdx.y * TCO;
  const uint32_t ws = smem_u32(smem);
  unsigned char* ring = smem + C::WRES;
  unsigned char* out = ring + STAGES * C::STAGE;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int iters = u1 - u0;
  if (iters <= 0) return;
  // ring steps: one a tile where resident, else one a (tile, pair, chunk)
  const int nch = C::RES ? 1 : Ci / C::KC;
  const int steps = C::RES ? iters : iters * 4 * nch;

  // warp (wm, wn): voxels [wm * WTM, +WTM) of the tile, parity c = wn
  const int wm = warp >> 1, wn = warp & 1;
  const int q = lane >> 3, r8 = lane & 7;

  // resident: the block's weights Wf[p, :, co0 .. co0 + TCO] for all 8
  // parities, rows (p, ci)
  if (C::RES)
    for (int i = threadIdx.x; i < 8 * Ci * C::PO; i += THREADS) {
      const int j = i % C::PO, r = i / C::PO;
      cp_async16(ws + swz(r, j, C::PO), wf + (size_t)r * g.Co + co0 + 8 * j,
                 true);
    }
  // ring step i: the x rows (hh, w) of its tile, channels of its chunk;
  // rows outside the volume are zero-filled. Streamed, also the weights of
  // its pair's two parities for the chunk, rows (c, k).
  auto stage = [&](int i, int slot) {
    int ti = i, ch = 0, l = 0;
    if (!C::RES) {  // i = (ti * 4 + l) * nch + ch
      ch = i % nch;
      l = i / nch % 4;
      ti = i / (4 * nch);
    }
    const Tile t = decode(g, u0 + ti, C::VH);
    const __nv_bfloat16* src =
        x + ((((size_t)t.n * g.D + t.d) * g.H + t.h0) * g.W + t.w0) * Ci +
        ch * C::KC;
    const uint32_t to = smem_u32(ring + slot * C::STAGE);
    const bool full = t.h0 + C::VH <= g.H && t.w0 + VW <= g.W;
    for (int k = threadIdx.x; k < TM * C::PX; k += THREADS) {
      const int r = k / C::PX, j = k - r * C::PX, hh = r / VW, w = r % VW;
      const bool in = full || (t.h0 + hh < g.H && t.w0 + w < g.W);
      cp_async16(to + swz(r, j, C::PX),
                 in ? src + ((size_t)hh * g.W + w) * Ci + 8 * j : x, in);
    }
    if (!C::RES)
      for (int k = threadIdx.x; k < 2 * C::KC * C::PO; k += THREADS) {
        const int j = k % C::PO, r = k / C::PO, c = r / C::KC;
        cp_async16(to + C::XB + swz(r, j, C::PO),
                   wf + ((size_t)(2 * l + c) * Ci + ch * C::KC + r % C::KC) *
                            g.Co + co0 + 8 * j,
                   true);
      }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage(s, s);
    cp_commit();
  }

  const int gr = lane >> 2, tc = 2 * (lane & 3);
  const size_t row = (size_t)2 * g.W * g.Co;      // elements of a fine row
  // The stores of a pair's staged outputs: the fine rows (2d + a, 2h + b),
  // w 2w0 .. 2w0 + 31, piece i = (hh, f, j), fine w f = 2k + c from staged
  // row c * TM + hh * 16 + k. With 4 pieces a row, the 8 fine voxels of a
  // warp's 32 pieces are taken in the order (k bit 1, c, k bit 0) so that
  // each 8 threads read two consecutive staged rows (distinct bank groups);
  // the warp still writes 512 contiguous bytes. They are issued under the
  // next pair's products (one slice per k-step of its first chunk), so the
  // stores stream while the tensor cores work; `pend` is the pending
  // pair's first fine row, ph / pw its tile's extent left in h and w.
  __nv_bfloat16* pend = nullptr;
  int ph = 0, pw = 0;
  auto store = [&](int s) {
    const int i = threadIdx.x + s * THREADS;
    const int j = i % C::PO;
    int e = i / C::PO;                            // hh * 32 + f
    if (C::PO == 4) {
      const int b3 = e & 7;
      e = (e & ~7) | (((b3 & 1) | ((b3 >> 1) & 2)) << 1) | ((b3 >> 1) & 1);
    }
    const int f = e % (2 * VW), hh = e / (2 * VW), k = f >> 1, c = f & 1;
    if (hh < ph && k < pw)
      *reinterpret_cast<uint4*>(pend + 2 * hh * row + (size_t)f * g.Co +
                                8 * j) =
          *reinterpret_cast<const uint4*>(
              out + swz(c * TM + hh * VW + k, j, C::PO));
  };

  int step = 0;
  uint32_t xs = 0;
  for (int it = 0; it < iters; ++it) {
    const Tile t = decode(g, u0 + it, C::VH);
    for (int l = 0; l < 4; ++l) {             // (a, b) = 2a + b
      float acc[C::MT][C::NT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      for (int ch = 0; ch < nch; ++ch) {
        if (!C::RES || l == 0) {  // the next ring step
          cp_wait<STAGES - 2>();
          __syncthreads();  // step landed; every warp is done with step - 1
          if (step + STAGES - 1 < steps)
            stage(step + STAGES - 1, (step + STAGES - 1) % STAGES);
          cp_commit();
          xs = smem_u32(ring + (step % STAGES) * C::STAGE);
          ++step;
        }
        // the warp's weight rows: parity 2 l + wn, resident or staged
        const uint32_t wb = C::RES ? ws : xs + C::XB;
        const int wrow = C::RES ? (2 * l + wn) * Ci : wn * C::KC;
#pragma unroll
        for (int ks = 0; ks < C::KS; ++ks) {
          // B (Wf[p] rows ci, .trans): matrices q = (k half q & 1, co half
          // q >> 1)
          uint32_t b[C::NT / 2][4];
#pragma unroll
          for (int j = 0; j < C::NT / 2; ++j)
            ldsm_x4_t(wb + swz(wrow + 16 * ks + 8 * (q & 1) + r8,
                               2 * j + (q >> 1), C::PO),
                      b[j]);
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt) {
            // A (x rows voxels): matrices q = (row half q & 1, k half
            // q >> 1)
            uint32_t a[4];
            ldsm_x4(xs + swz(wm * C::WTM + 16 * mt + 8 * (q & 1) + r8,
                             2 * ks + (q >> 1), C::PX),
                    a);
#pragma unroll
            for (int nt = 0; nt < C::NT; ++nt)
              mma16816(acc[mt][nt], a, b[nt >> 1][(nt & 1) * 2],
                       b[nt >> 1][(nt & 1) * 2 + 1]);
          }
          if (ch == 0 && pend) {
#pragma unroll
            for (int s = ks * C::NS / C::KS; s < (ks + 1) * C::NS / C::KS;
                 ++s)
              store(s);
          }
        }
      }

      __syncthreads();  // the pending pair's stores have read the staging
      // acc[mt][nt][e]: voxel v = wm * WTM + 16 mt + lane / 4 + 8 (e >> 1),
      // co = 8 nt + 2 (lane % 4) + (e & 1), parity c = wn: staged row
      // c * TM + v (up2_row)
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wn * TM + wm * C::WTM + 16 * mt + gr + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(out + swz(r, nt, C::PO) +
                                               2 * tc) =
                __floats2bfloat162_rn(acc[mt][nt][2 * h],
                                      acc[mt][nt][2 * h + 1]);
          }
      __syncthreads();
      pend = y + ((((size_t)t.n * 2 * g.D + 2 * t.d + (l >> 1)) * 2 * g.H +
                   2 * t.h0 + (l & 1)) * 2 * g.W + 2 * t.w0) * g.Co + co0;
      ph = g.H - t.h0, pw = g.W - t.w0;
    }
  }
  for (int s = 0; s < C::NS; ++s) store(s);  // the block's last pair
}

template <int TM, int TCO, int CI>
cudaError_t launch(dim3 grid, int smem, cudaStream_t st, const void* x,
                   const void* wf, void* y, const Geom& g, int units) {
  if (smem != FwdCfg<TM, TCO, CI>::SMEM) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upsample2x_ndhwc_mma<TM, TCO, CI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  upsample2x_ndhwc_mma<TM, TCO, CI><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wf), static_cast<__nv_bfloat16*>(y),
      g, units);
  return cudaGetLastError();
}

}  // namespace

// y (N, 2Di, 2Hi, 2Wi, Co) bf16 = upsample(x (N, Di, Hi, Wi, Ci), wf
// (2, 2, 2, Ci, Co) flipped), in tiles of tm coarse voxels x tco output
// channels (ops/upsample.py _up_fwd_plan): (128, 64) with resident weights
// at 128->64, (256, 32) at 64->32, else (64, 32) with the weights
// streamed. `grid` persistent blocks per co tile walk the `tiles` tiles;
// `smem` is the plan's shared memory, which must be the configuration's,
// as `tiles` must be the volume's. Returns the cudaGetLastError() code.
extern "C" int upsample2x_ndhwc_launch(const void* x, const void* wf, void* y,
                                       int N, int Di, int Hi, int Wi, int Ci,
                                       int Co, int tm, int tco, int smem,
                                       int tiles, int grid, void* stream) {
  if (Ci % 32 != 0 || Co % 32 != 0 || N < 1 || Di < 1 || Hi < 1 || Wi < 1 ||
      grid < 1 || tco < 1 || Co % tco != 0)
    return (int)cudaErrorInvalidValue;
  const int cfg = tm == 128 && tco == 64 && Ci == 128  ? 0
                  : tm == 256 && tco == 32 && Ci == 64 ? 1
                  : tm == 64 && tco == 32              ? 2
                                                       : -1;
  if (cfg < 0) return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N, g.D = Di, g.H = Hi, g.W = Wi, g.Ci = Ci, g.Co = Co;
  g.nhg = (Hi + tm / VW - 1) / (tm / VW);
  g.nwg = (Wi + VW - 1) / VW;
  const long long units = (long long)N * Di * g.nhg * g.nwg;
  if (units != tiles || Co / tco > 65535) return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)(grid < tiles ? grid : tiles),
                    (unsigned)(Co / tco));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return (int)launch<128, 64, 128>(blocks, smem, st, x, wf, y, g, tiles);
    case 1: return (int)launch<256, 32, 64>(blocks, smem, st, x, wf, y, g, tiles);
    default: return (int)launch<64, 32, 0>(blocks, smem, st, x, wf, y, g, tiles);
  }
}
