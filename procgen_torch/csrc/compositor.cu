// Sprite compositor for Hopper (sm_90a): blends z-sorted entity records over
// a batch of 64x64 RGB float canvases.
//
// Replaces the TPU kernel procgen_tpu/render/pallas_compositor.py:_kernel
// (launched by _build_call, fed by _select_textures) and its XLA twin
// procgen_tpu/render/fast2.py:composite_entities.  Both sample textures with
// one-hot matmuls because a TPU gathers slowly; here each thread reads its
// texel straight from the uint8 variant atlas, which is small and stays in
// L1/L2, so there is no per-(env, record) texture block in device memory.
//
// Layout (the JAX package's boundary layout):
//   records    (N, E, 11) f32, fields bbx0 bby0 bbw bbh var refl alpha ok
//              n_th n_tv z (fast2._RF), z-sorted, non-drawable records last
//   atlas      (NV, R, R, 4) uint8 RGBA
//   kmax       int32 scalar on the device; records at or past it are not
//              read (they have ok = 0, so this only saves work)
//   canvas_in  (N, 64, 64, 3) f32, canvas_out the same shape (separate);
//              both 16-byte aligned (the wrapper checks)
//
// Bound: memory.  The kernel must read and write the f32 canvas, 2 x 49,152
// bytes per env, and read the kmax records it draws (44 bytes each); at
// N = 4096 that is 403 MB, about 0.12 ms at 3.35 TB/s.  The least arithmetic
// is one blend per pixel inside a drawn box, a few dozen per env.
//
// Design: one block per env.  The first design kept the canvas in registers
// (16 pixels a thread) and evaluated all 4,096 pixels for every drawn record,
// which made it instruction-bound wherever many small records are drawn
// (coinrun, leaper: 22-25% of the byte bound).  Now:
//   1. One thread copies the env's canvas (49,152 contiguous bytes) into
//      shared memory with one bulk asynchronous copy (cp.async.bulk, the TMA
//      without a tensor map), completing on an mbarrier.  Meanwhile the block
//      stages the records, CHUNK at a time, with coalesced loads that are
//      issued one chunk ahead into registers, so a long walk (coinrun's
//      kmax of about 200, of which about 15 draw) waits on no load.
//   2. One warp compacts each chunk (ballot and prefix count) to the records
//      it draws: ok > 0, passing z_filter, and with a non-empty pixel span.
//      It precomputes each one's span, atlas entry and alpha scale.
//   3. Each record is clipped to its conservative pixel span, and each warp
//      owns a band of BAND canvas rows: it walks the records in order and
//      draws each over the part of its span inside the band (records that
//      miss the band cost it one shared read), with __syncwarp between
//      records for z order.  Each pixel still runs the exact box test and
//      the same arithmetic.  The eight warps' record chains run apart; a
//      block-wide barrier per record was 1.1-1.6x slower at 16-160 drawn
//      records per env (PERF.md).
//      Skipping a pixel the exact test rejects is exact: there the first
//      design computed c = 0 + c * (1 - 0) = c, which changes no bit as long
//      as the canvas holds no -0.0 and no NaN (the main path's canvases are
//      all >= +0; chip_smoke.py checks it).
//   4. The canvas goes back with one bulk copy shared -> global (1-5% faster
//      than coalesced 16-byte stores).
// Shared memory: the 48 KB canvas plus one chunk of raw and compacted
// records, 54,528 bytes: four blocks of 256 threads (32 warps) per SM
// (128 threads a block was 1-20% slower).
//
// Numerics: the result must equal the plain PyTorch version bit for bit.
// The file is built with -fmad=false and every float op that matters is an
// explicitly rounded intrinsic, in the reference package's order:
//   col = (px - bbx0) / bbw; u = frac(col * n_th) if n_th > 1
//   su  = clip(int(clip(u, 0, .9999) * R), 0, R-1), mirrored if refl
//   a_t = tex_a * (alpha / 255); s = bf16(rgb * a_t); a = bf16(a_t)
//   c   = s + c * (1 - a)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RES = 64;
constexpr int NPIX = RES * RES;
constexpr int CANVAS_BYTES = NPIX * 3 * (int)sizeof(float);  // 49,152
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int BAND = RES / (THREADS / 32);  // canvas rows a warp owns
constexpr int CHUNK = 64;  // records staged at a time: two rounds of one warp
constexpr int NF = 11;
enum Field { BBX0, BBY0, BBW, BBH, VAR, REFL, ALPHA, OK, NTH, NTV, Z };

// A record that draws, ready for the pixel loop.
struct Rec {
  float bbx0, bby0, bbw, bbh, n_th, n_tv, a_scale;
  int vi;    // atlas entry, or -1 when the variant names none (texel 0)
  int refl;
  int span;  // x_lo | x_hi << 8 | y_lo << 16 | y_hi << 24
};

constexpr int RAW_BYTES = CHUNK * NF * (int)sizeof(float);
constexpr int PF = (CHUNK * NF + THREADS - 1) / THREADS;  // raw floats a thread stages
constexpr int SMEM_BYTES = CANVAS_BYTES + RAW_BYTES + CHUNK * (int)sizeof(Rec);

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Texel index along one axis: t is col or row, n the tile count.
__device__ __forceinline__ int texel_coord(float t, float n, int R) {
  float u = t;
  if (n > 1.f) {
    const float raw = __fmul_rn(t, n);
    u = __fsub_rn(raw, floorf(raw));
  }
  u = fminf(fmaxf(u, 0.f), 0.9999f);
  const int s = __float2int_rz(__fmul_rn(u, (float)R));
  return min(max(s, 0), R - 1);
}

// Conservative pixel span [first, end) of one box axis (edge lo, size): a
// pixel whose centre the exact test (px - lo) / size in [0, 1) accepts lies
// inside.  For size > 0 an accepted centre satisfies lo <= px < lo + size
// exactly; the margins cover the rounding of lo - 1.5 and lo + size + 0.5,
// and the clamp to [0, 64] happens in float, before the conversion, since
// boxes lie partly or far off screen.  A size outside (0, 1e30) takes the
// whole axis: a size that is not > 0 flips or voids the box, and past 2^126
// (px - lo) / size can underflow to -0.0, which the test accepts left of lo.
// Neither occurs on the main path (sizes are clamped at 1e-6, sprites are a
// few cells).  Mirrored by procgen_torch/render/compositor.py:pixel_span,
// which the CPU tests hold against the plain version's exact test.
__device__ __forceinline__ void pixel_span(float lo, float size, int& first, int& end) {
  if (!(size > 0.f && size < 1e30f)) {
    first = 0;
    end = RES;
    return;
  }
  const float f = floorf(__fsub_rn(lo, 1.5f));
  const float e = ceilf(__fadd_rn(__fadd_rn(lo, size), 0.5f));
  first = __float2int_rz(fminf(fmaxf(f, 0.f), (float)RES));
  end = __float2int_rz(fminf(fmaxf(e, 0.f), (float)RES));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One warp: compact the chunk's cnt raw records to those that draw, in
// order, and precompute them.  Returns the count (on every lane).
__device__ __forceinline__ int stage_chunk(const float* raw, int cnt, Rec* recs,
                                           int z_filter, int NV, int lane) {
  int nd = 0;
#pragma unroll
  for (int r0 = 0; r0 < CHUNK; r0 += 32) {
    const int k = r0 + lane;
    const float* f = raw + k * NF;
    bool draw = false;
    int x0 = 0, x1 = 0, y0 = 0, y1 = 0;
    if (k < cnt) {
      draw = f[OK] > 0.f;
      if (z_filter == 1) draw = draw && f[Z] < 0.f;
      if (z_filter == 2) draw = draw && f[Z] >= 0.f;
      pixel_span(f[BBX0], f[BBW], x0, x1);
      pixel_span(f[BBY0], f[BBH], y0, y1);
      draw = draw && x0 < x1 && y0 < y1;
    }
    const unsigned b = __ballot_sync(0xffffffffu, draw);
    if (draw) {
      Rec& r = recs[nd + __popc(b & ((1u << lane) - 1u))];
      r.bbx0 = f[BBX0];
      r.bby0 = f[BBY0];
      r.bbw = f[BBW];
      r.bbh = f[BBH];
      r.n_th = f[NTH];
      r.n_tv = f[NTV];
      r.a_scale = __fdiv_rn(f[ALPHA], 255.f);
      // the variant id must name an atlas entry exactly (a one-hot row)
      const float var = f[VAR];
      const int vi = __float2int_rz(var);
      r.vi = ((float)vi == var && vi >= 0 && vi < NV) ? vi : -1;
      r.refl = f[REFL] > 0.f;
      r.span = x0 | x1 << 8 | y0 << 16 | y1 << 24;
    }
    nd += __popc(b);
  }
  return nd;
}

// Loads this thread's share of the raw chunk at record base (none past
// kend) into registers: PF independent loads, in flight together.
__device__ __forceinline__ void load_chunk(float (&pf)[PF], const float* __restrict__ rec_g,
                                           int base, int kend, int t) {
  const int n = min(CHUNK, kend - base) * NF;
#pragma unroll
  for (int p = 0; p < PF; ++p) {
    const int i = t + p * THREADS;
    pf[p] = i < n ? __ldg(rec_g + base * NF + i) : 0.f;
  }
}

// One warp draws record r over the rows [row0, row1) of its span, each
// pixel of the span's 2^lw-wide rows once (a power-of-two row width, so no
// division).
__device__ __forceinline__ void draw_rows(const Rec& r, float* canvas,
                                          const uint8_t* __restrict__ atlas,
                                          int R, int lane, int row0, int row1) {
  const int x0 = r.span & 0xff, x1 = (r.span >> 8) & 0xff;
  const int y0 = max((r.span >> 16) & 0xff, row0);
  const int y1 = min((r.span >> 24) & 0xff, row1);
  const int lw = 32 - __clz(x1 - x0 - 1);  // 2^lw >= span width
  const int n = max(y1 - y0, 0) << lw;
  for (int i = lane; i < n; i += 32) {
    const int x = x0 + (i & ((1 << lw) - 1));
    if (x >= x1) continue;
    const int y = y0 + (i >> lw);
    const float col = __fdiv_rn(__fsub_rn((float)x + 0.5f, r.bbx0), r.bbw);
    const float row = __fdiv_rn(__fsub_rn((float)y + 0.5f, r.bby0), r.bbh);
    if (!(col >= 0.f && col < 1.f && row >= 0.f && row < 1.f)) continue;
    uchar4 tx4 = make_uchar4(0, 0, 0, 0);
    if (r.vi >= 0) {
      int su = texel_coord(col, r.n_th, R);
      if (r.refl) su = R - 1 - su;
      const int sv = texel_coord(row, r.n_tv, R);
      tx4 = __ldg(reinterpret_cast<const uchar4*>(
          atlas + (((size_t)r.vi * R + sv) * R + su) * 4));
    }
    const float at = __fmul_rn((float)tx4.w, r.a_scale);
    const float sr = bf16_round(__fmul_rn((float)tx4.x, at));
    const float sg = bf16_round(__fmul_rn((float)tx4.y, at));
    const float sb = bf16_round(__fmul_rn((float)tx4.z, at));
    const float oma = __fsub_rn(1.f, bf16_round(at));
    float* c = canvas + (y * RES + x) * 3;
    c[0] = __fadd_rn(sr, __fmul_rn(c[0], oma));
    c[1] = __fadd_rn(sg, __fmul_rn(c[1], oma));
    c[2] = __fadd_rn(sb, __fmul_rn(c[2], oma));
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
composite_kernel(const float* __restrict__ records,
                 const uint8_t* __restrict__ atlas,
                 const int* __restrict__ kmax,
                 const float* __restrict__ canvas_in,
                 float* __restrict__ canvas_out,
                 int E, int NV, int R, int z_filter) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* canvas = reinterpret_cast<float*>(smem);
  float* raw = reinterpret_cast<float*>(smem + CANVAS_BYTES);
  Rec* recs = reinterpret_cast<Rec*>(smem + CANVAS_BYTES + RAW_BYTES);
  __shared__ uint64_t bar;
  __shared__ int n_draw;
  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const uint32_t bar_a = smem_u32(&bar);

  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar_a), "r"(CANVAS_BYTES) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(canvas)), "l"(canvas_in + (size_t)n * NPIX * 3),
           "r"(CANVAS_BYTES), "r"(bar_a)
        : "memory");
  }
  __syncthreads();  // the mbarrier is initialised before anyone waits on it

  const int kend = min(E, *kmax);
  const float* rec_g = records + (size_t)n * E * NF;
  float pf[PF];
  load_chunk(pf, rec_g, 0, kend, t);
  for (int base = 0; base < kend; base += CHUNK) {
    const int cnt = min(CHUNK, kend - base);
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int i = t + p * THREADS;
      if (i < cnt * NF) raw[i] = pf[p];
    }
    load_chunk(pf, rec_g, base + CHUNK, kend, t);  // in flight during this chunk
    __syncthreads();
    if (t < 32) {
      const int nd = stage_chunk(raw, cnt, recs, z_filter, NV, t);
      if (t == 0) n_draw = nd;
    }
    __syncthreads();
    mbar_wait(bar_a, 0);  // the canvas has landed (returns at once later)
    const int nd = n_draw;
    // warp wp owns the rows [wp * BAND, (wp + 1) * BAND) and draws every
    // record in order over them; records that miss its band cost it a read
    const int lane = t & 31, row0 = (t >> 5) * BAND;
    for (int j = 0; j < nd; ++j) {
      draw_rows(recs[j], canvas, atlas, R, lane, row0, row0 + BAND);
      __syncwarp();  // record j is written before record j + 1 starts
    }
    __syncthreads();  // the chunk's records are drawn before the next is staged
  }
  mbar_wait(bar_a, 0);

  float* cout = canvas_out + (size_t)n * NPIX * 3;
  // this thread's canvas writes become visible to the bulk copy's proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (t == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(cout), "r"(smem_u32(canvas)), "r"(CANVAS_BYTES) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // shared memory must outlive the copy's reads of it
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(composite_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int composite_entities_launch(const float* records,
                                         const uint8_t* atlas,
                                         const int* kmax,
                                         const float* canvas_in,
                                         float* canvas_out, int N, int E,
                                         int NV, int R, int z_filter,
                                         void* stream) {
  if (N == 0) return 0;
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return (int)err;
  composite_kernel<<<N, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      records, atlas, kmax, canvas_in, canvas_out, E, NV, R, z_filter);
  return (int)cudaGetLastError();
}

// Resident blocks per SM at the launch configuration (for the records), or
// a negative CUDA error code.
extern "C" int composite_entities_blocks_per_sm(void) {
  cudaError_t err = set_attributes();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, composite_kernel,
                                                        THREADS, SMEM_BYTES);
  return err == cudaSuccess ? blocks : -(int)err;
}
