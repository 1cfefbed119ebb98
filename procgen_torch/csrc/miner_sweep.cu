// Miner's gravity sweep on the card (miner.cpp:267-303), one thread per
// env.  Wrapper and plain version: procgen_torch/games/miner.py
// (MinerGame.gravity_sweep, gravity_sweep_ref); the per-env code, shared
// with the host build that the CPU tests run, is miner_sweep.cuh.
//
// It replaces no TPU kernel: the JAX package ran this loop as a fori_loop
// under jit, where XLA fused it.  Eager PyTorch ran it as about 25 ops per
// cell over the batch, 26,851 launches a step at miner hard (400 cells),
// with the card idle between them.
//
// What bounds it: each env is one chain of dependent steps over its cells
// in ascending order (a read of the cell, and for a boulder or diamond the
// cell below and up to four neighbours, then one or two writes): a few
// dozen dependent integer and shared-memory steps a cell, 400 cells at
// hard, 1,225 at memory.  The bytes are the grid read and written once,
// 2 x 4096 x 400 x 4 B = 13 MB at hard, about 4 us at 3.35 TB/s, so the
// chain bounds it.  The design keeps the chain short and the warp in step:
// a block stages the grids of its 32 envs in shared memory, cell-major and
// env-minor, one byte a cell, 33 bytes a cell row (13.2 KB at hard, 40.4 KB
// at memory), with coalesced int32 reads of its envs' contiguous rows; then
// one warp sweeps, thread e over env e, so that each step of the warp reads
// or writes 32 neighbouring bytes, one shared-memory transaction; then the
// block stores the grids back coalesced.  Every env of a batch has the
// same W, so the warp parts only at the data-dependent branches (what lies
// in a cell and below it).  4096 envs make 128 blocks, one an SM.
#include <cuda_runtime.h>

#include <cstdint>

#include "miner_sweep.cuh"

namespace {

constexpr int ENVS = 32;          // envs a block; one warp sweeps them
constexpr int THREADS = 256;      // threads that stage the grids
constexpr int PITCH = ENVS + 1;   // bytes a cell row in shared memory
constexpr int BATCH = 8;          // loads each staging thread keeps in flight
constexpr int MAX_DIM = 38;       // W * W * PITCH within 48 KB

__global__ void __launch_bounds__(THREADS)
sweep_kernel(const int32_t* __restrict__ grid_in, const int32_t* __restrict__ agent_fall,
             const int64_t* __restrict__ agent_free, int N, int W,
             int32_t* __restrict__ grid_out, int32_t* __restrict__ diamonds,
             bool* __restrict__ crushed) {
    extern __shared__ uint8_t s[];
    const int area = W * W;
    const int b0 = blockIdx.x * ENVS;
    const int envs = min(ENVS, N - b0);
    const int total = envs * area;  // the block's rows are contiguous
    const int32_t* src = grid_in + (int64_t)b0 * area;
    int32_t* dst = grid_out + (int64_t)b0 * area;

    for (int i0 = threadIdx.x; i0 < total; i0 += THREADS * BATCH) {
        int32_t v[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; k++) {
            const int i = i0 + k * THREADS;
            v[k] = i < total ? src[i] : 0;
        }
#pragma unroll
        for (int k = 0; k < BATCH; k++) {
            const int i = i0 + k * THREADS;
            if (i < total) {
                const int e = i / area;
                s[(i - e * area) * PITCH + e] = (uint8_t)v[k];
            }
        }
    }
    __syncthreads();

    if (threadIdx.x < envs) {
        const int b = b0 + threadIdx.x;
        bool crush;
        diamonds[b] = miner_sweep::sweep_env(s + threadIdx.x, PITCH, W, agent_fall[b],
                                             agent_free[b], &crush);
        crushed[b] = crush;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < total; i += THREADS) {
        const int e = i / area;
        dst[i] = s[(i - e * area) * PITCH + e];
    }
}

}  // namespace

// Returns 0, or the CUDA error of the launch.
extern "C" int miner_sweep_launch(const int32_t* grid_in, const int32_t* agent_fall,
                                  const int64_t* agent_free, int N, int W, int32_t* grid_out,
                                  int32_t* diamonds, bool* crushed, void* stream) {
    if (N <= 0) return 0;
    if (W < 1 || W > MAX_DIM) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)W * W * PITCH;
    sweep_kernel<<<(N + ENVS - 1) / ENVS, THREADS, smem, (cudaStream_t)stream>>>(
        grid_in, agent_fall, agent_free, N, W, grid_out, diamonds, crushed);
    return (int)cudaGetLastError();
}
