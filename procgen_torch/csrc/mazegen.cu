// Maze level generation on the card: Kruskal's maze (mazegen.cpp:112-187)
// and object placement (:292-306), one thread per env.  Wrapper and plain
// version: procgen_torch/engine/levelgen/mazegen.py; the per-env code,
// shared with the host build that the CPU tests run, is mazegen.cuh.
//
// It replaces no TPU kernel: the JAX package ran this loop under jit, where
// XLA fused it.  Eager PyTorch ran it as about 140 ops per wall (312 walls
// at maze hard), some 44,600 launches per refill pass, with the card idle
// between them.
//
// What bounds it: each env is one chain of dependent integer steps (a
// draw, the survivor lookup over at most 15 bitmap words, two union-find
// roots and up to three grid writes per wall), some 10,000 steps at
// max_dim 31, while the bytes are a few KB per env.  The envs are
// independent and the chains are equally long for one maze size, so one
// thread per env keeps every step in registers (the survivor bitmap) or in
// the thread's own local memory (256 bytes of union-find), and warps of
// envs of one size run without divergence.  Maze mixes sizes in a warp: a
// warp then runs as long as its largest env, plus the branches where its
// envs part (a join or not, a vertical or a horizontal wall, the roots'
// path lengths), and each grid access is a transaction in its own env's
// row, so a batch takes longer than its largest env alone.  Blocks of 32
// threads spread a refill bucket of 512 envs over 16 SMs, 4096 envs over
// the whole card.
#include <cuda_runtime.h>

#include <cstdint>

#include "mazegen.cuh"

namespace {

constexpr int THREADS = 32;

__global__ void generate_kernel(const int64_t* __restrict__ vals,
                                const int32_t* __restrict__ cursor_in,
                                const int32_t* __restrict__ maze_dim, int B, int D,
                                int max_dim, int wall_obj, int space_obj,
                                int32_t* __restrict__ grid, int32_t* __restrict__ free_cells,
                                int32_t* __restrict__ num_free,
                                int32_t* __restrict__ cursor_out) {
    int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int AD = max_dim + 2;
    mazegen::Draws rs{vals + (int64_t)b * D, D, cursor_in[b]};
    num_free[b] = mazegen::generate_env(rs, maze_dim[b], max_dim, wall_obj, space_obj,
                                        grid + (int64_t)b * AD * AD,
                                        free_cells + (int64_t)b * max_dim * max_dim);
    cursor_out[b] = rs.cursor;
}

__global__ void place_kernel(const int64_t* __restrict__ vals,
                             const int32_t* __restrict__ cursor_in,
                             const int32_t* __restrict__ maze_dim,
                             const int32_t* __restrict__ num_free, int B, int D, int max_dim,
                             int start_obj, int num_objs, int max_tries,
                             int32_t* __restrict__ grid, int32_t* __restrict__ free_cells,
                             int32_t* __restrict__ cursor_out) {
    int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int AD = max_dim + 2;
    mazegen::Draws rs{vals + (int64_t)b * D, D, cursor_in[b]};
    mazegen::place_env(rs, maze_dim[b], max_dim, num_free[b], start_obj, num_objs, max_tries,
                       grid + (int64_t)b * AD * AD, free_cells + (int64_t)b * max_dim * max_dim);
    cursor_out[b] = rs.cursor;
}

int blocks(int B) { return (B + THREADS - 1) / THREADS; }

}  // namespace

// Returns 0, or the CUDA error of the launch.
extern "C" int mazegen_generate_launch(const int64_t* vals, const int32_t* cursor_in,
                                       const int32_t* maze_dim, int B, int D, int max_dim,
                                       int wall_obj, int space_obj, int32_t* grid,
                                       int32_t* free_cells, int32_t* num_free,
                                       int32_t* cursor_out, void* stream) {
    if (B <= 0) return 0;
    generate_kernel<<<blocks(B), THREADS, 0, (cudaStream_t)stream>>>(
        vals, cursor_in, maze_dim, B, D, max_dim, wall_obj, space_obj, grid, free_cells,
        num_free, cursor_out);
    return (int)cudaGetLastError();
}

extern "C" int mazegen_place_launch(const int64_t* vals, const int32_t* cursor_in,
                                    const int32_t* maze_dim, const int32_t* num_free, int B,
                                    int D, int max_dim, int start_obj, int num_objs,
                                    int max_tries, int32_t* grid, int32_t* free_cells,
                                    int32_t* cursor_out, void* stream) {
    if (B <= 0) return 0;
    place_kernel<<<blocks(B), THREADS, 0, (cudaStream_t)stream>>>(
        vals, cursor_in, maze_dim, num_free, B, D, max_dim, start_obj, num_objs, max_tries,
        grid, free_cells, cursor_out);
    return (int)cudaGetLastError();
}
