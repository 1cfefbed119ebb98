// Host build of the maze kernels' per-env code (mazegen.cuh), a loop over
// envs with the kernels' arguments, so that the CPU tests hold the
// kernels' logic against the plain version (procgen_torch/engine/levelgen/
// mazegen.py).  Built with g++; not on any main path.
#include <cstdint>

#include "mazegen.cuh"

extern "C" int mazegen_generate_host(const int64_t* vals, const int32_t* cursor_in,
                                     const int32_t* maze_dim, int B, int D, int max_dim,
                                     int wall_obj, int space_obj, int32_t* grid,
                                     int32_t* free_cells, int32_t* num_free,
                                     int32_t* cursor_out) {
    const int AD = max_dim + 2;
    for (int b = 0; b < B; b++) {
        mazegen::Draws rs{vals + (int64_t)b * D, D, cursor_in[b]};
        num_free[b] = mazegen::generate_env(rs, maze_dim[b], max_dim, wall_obj, space_obj,
                                            grid + (int64_t)b * AD * AD,
                                            free_cells + (int64_t)b * max_dim * max_dim);
        cursor_out[b] = rs.cursor;
    }
    return 0;
}

extern "C" int mazegen_place_host(const int64_t* vals, const int32_t* cursor_in,
                                  const int32_t* maze_dim, const int32_t* num_free, int B,
                                  int D, int max_dim, int start_obj, int num_objs,
                                  int max_tries, int32_t* grid, int32_t* free_cells,
                                  int32_t* cursor_out) {
    const int AD = max_dim + 2;
    for (int b = 0; b < B; b++) {
        mazegen::Draws rs{vals + (int64_t)b * D, D, cursor_in[b]};
        mazegen::place_env(rs, maze_dim[b], max_dim, num_free[b], start_obj, num_objs,
                           max_tries, grid + (int64_t)b * AD * AD,
                           free_cells + (int64_t)b * max_dim * max_dim);
        cursor_out[b] = rs.cursor;
    }
    return 0;
}
