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
//   canvas_in  (N, 64, 64, 3) f32, canvas_out the same shape (separate)
//
// Design: one block per env, 256 threads, 16 pixels per thread.  Pixel p of
// thread t is p = j * 256 + t, so a thread keeps one column x = t % 64 and
// its column math (col, su) is done once per record.  The 48 canvas values of
// a thread stay in registers across all records: the canvas is read once and
// written once.  The block stages the records it can draw, the first
// min(E, kmax), in shared memory and walks them in order, skipping ok <= 0
// and records that fail z_filter; records past kmax are never read.
//
// Numerics: the result must equal the plain PyTorch version bit for bit.
// The file is built with -fmad=false and every float op that matters is an
// explicitly rounded intrinsic, in the reference package's order:
//   col = (px - bbx0) / bbw; u = frac(col * n_th) if n_th > 1
//   su  = clip(int(clip(u, 0, .9999) * R), 0, R-1), mirrored if refl
//   a_t = tex_a * (alpha / 255); s = bf16(rgb * a_t); a = bf16(a_t)
//   c   = s + c * (1 - a)
//
// Bound: memory.  The kernel must read and write the f32 canvas, 2 x 49,152
// bytes per env, and read the kmax records it draws (44 bytes each); at
// N = 4096 that is 403 MB, about 0.12 ms at 3.35 TB/s.  Fusing the uint8
// static-layer read and the final clip(x + 0.5) uint8 store
// (fast2.render_frames2) into this kernel would cut that traffic 4x; that is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RES = 64;
constexpr int NPIX = RES * RES;
constexpr int THREADS = 256;
constexpr int PPT = NPIX / THREADS;  // pixels per thread
constexpr int ROWS_PER_PASS = THREADS / RES;
constexpr int NF = 11;
enum Field { BBX0, BBY0, BBW, BBH, VAR, REFL, ALPHA, OK, NTH, NTV, Z };

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

__global__ void __launch_bounds__(THREADS)
composite_kernel(const float* __restrict__ records,
                 const uint8_t* __restrict__ atlas,
                 const int* __restrict__ kmax,
                 const float* __restrict__ canvas_in,
                 float* __restrict__ canvas_out,
                 int E, int NV, int R, int z_filter) {
  extern __shared__ float rec_s[];  // E * NF
  const int n = blockIdx.x;
  const int t = threadIdx.x;

  const int kend = min(E, *kmax);
  const float* rec_g = records + (size_t)n * E * NF;
  for (int i = t; i < kend * NF; i += THREADS) rec_s[i] = rec_g[i];

  const float* cin = canvas_in + (size_t)n * NPIX * 3;
  float c[PPT][3];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = j * THREADS + t;
    c[j][0] = cin[p * 3 + 0];
    c[j][1] = cin[p * 3 + 1];
    c[j][2] = cin[p * 3 + 2];
  }
  __syncthreads();

  const float px = (float)(t % RES) + 0.5f;
  const int y_base = t / RES;
  for (int k = 0; k < kend; ++k) {
    const float* r = rec_s + k * NF;
    if (!(r[OK] > 0.f)) continue;
    if (z_filter == 1 && !(r[Z] < 0.f)) continue;
    if (z_filter == 2 && !(r[Z] >= 0.f)) continue;

    const float col = __fdiv_rn(__fsub_rn(px, r[BBX0]), r[BBW]);
    const bool in_x = col >= 0.f && col < 1.f;
    int su = texel_coord(col, r[NTH], R);
    if (r[REFL] > 0.f) su = R - 1 - su;
    // the variant id must name an atlas entry exactly (a one-hot row)
    const float var = r[VAR];
    const int vi = __float2int_rz(var);
    const bool var_ok = (float)vi == var && vi >= 0 && vi < NV;
    const float a_scale = __fdiv_rn(r[ALPHA], 255.f);

#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float py = (float)(j * ROWS_PER_PASS + y_base) + 0.5f;
      const float row = __fdiv_rn(__fsub_rn(py, r[BBY0]), r[BBH]);
      float sr = 0.f, sg = 0.f, sb = 0.f, sa = 0.f;
      if (in_x && row >= 0.f && row < 1.f) {
        uchar4 tx = make_uchar4(0, 0, 0, 0);
        if (var_ok) {
          const int sv = texel_coord(row, r[NTV], R);
          tx = *reinterpret_cast<const uchar4*>(
              atlas + (((size_t)vi * R + sv) * R + su) * 4);
        }
        const float at = __fmul_rn((float)tx.w, a_scale);
        sr = bf16_round(__fmul_rn((float)tx.x, at));
        sg = bf16_round(__fmul_rn((float)tx.y, at));
        sb = bf16_round(__fmul_rn((float)tx.z, at));
        sa = bf16_round(at);
      }
      const float oma = __fsub_rn(1.f, sa);
      c[j][0] = __fadd_rn(sr, __fmul_rn(c[j][0], oma));
      c[j][1] = __fadd_rn(sg, __fmul_rn(c[j][1], oma));
      c[j][2] = __fadd_rn(sb, __fmul_rn(c[j][2], oma));
    }
  }

  float* cout = canvas_out + (size_t)n * NPIX * 3;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = j * THREADS + t;
    cout[p * 3 + 0] = c[j][0];
    cout[p * 3 + 1] = c[j][1];
    cout[p * 3 + 2] = c[j][2];
  }
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
  const size_t smem = (size_t)E * NF * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  composite_kernel<<<N, THREADS, smem, (cudaStream_t)stream>>>(
      records, atlas, kmax, canvas_in, canvas_out, E, NV, R, z_filter);
  return (int)cudaGetLastError();
}
