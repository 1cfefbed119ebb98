// Kruskal maze generation and object placement for one env (reference
// procgen/src/mazegen.cpp:112-187 and :292-306), shared by the CUDA kernels
// of mazegen.cu (one thread per env) and the host build of
// mazegen_host.cpp (a loop over envs, for the CPU tests).  The plain
// version is procgen_torch/engine/levelgen/mazegen.py (generate_maze_ref,
// place_objects_ref); these functions consume the same draws and write
// the same bits:
//
// * Draws come from an open MTBlock row (vals: D tempered outputs): a draw
//   reads vals[min(cursor, D - 1)] and advances the cursor only where it
//   is active; randn(high) is x % uint32(high), and 0 when high is 0.
// * Kruskal draws once per wall, for k < n_walls, from the walls not yet
//   removed: the logical index picks the n-th survivor in construction
//   order (verticals with i outer, then horizontals), here through a
//   bitmap of survivors kept in registers and a popcount over its words.
//   A drawn wall is always removed from the list.
// * The sets are a union-find over the cells with two even coordinates
//   (the only cells a wall joins): it answers s0 != s1 exactly as the
//   plain version's relabel does; the labels themselves are no output.
// * A cell enters the free list the first time it is set free, which is
//   when its grid value is not yet SPACE (cell (0, 0) starts at 0), in the
//   order (x1, y1), (x0, y0), (x2, y2).
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define MZ_HD __host__ __device__ __forceinline__
#else
#define MZ_HD inline
#endif

namespace mazegen {

constexpr int MAX_DIM = 31;                              // maze memory mode
constexpr int HALF = (MAX_DIM + 1) / 2;                  // even coordinates
constexpr int MAX_WALLS = 2 * ((MAX_DIM - 1) / 2) * HALF;  // 480
constexpr int WORDS = (MAX_WALLS + 31) / 32;             // 15

MZ_HD int popc(uint32_t w) {
#if defined(__CUDA_ARCH__)
    return __popc(w);
#else
    return __builtin_popcount(w);
#endif
}

// Position of the r-th set bit (from 0) of w, which has more than r.
MZ_HD int nth_set_bit(uint32_t w, int r) {
    int pos = 0;
    for (int half = 16; half; half >>= 1) {
        uint32_t lo = w & ((1u << half) - 1u);
        int c = popc(lo);
        if (r >= c) {
            r -= c;
            w >>= half;
            pos += half;
        } else {
            w = lo;
        }
    }
    return pos;
}

// RandGen::randn over an MTBlock row (rng.py: blk_raw, randn_value).
struct Draws {
    const int64_t* vals;
    int D;
    int32_t cursor;

    MZ_HD int32_t randn(int32_t high, bool active = true) {
        uint32_t x = (uint32_t)vals[cursor < D - 1 ? cursor : D - 1];
        cursor += active ? 1 : 0;
        uint32_t h = (uint32_t)high;
        return h ? (int32_t)(x % h) : 0;
    }
};

MZ_HD int find_root(uint8_t* parent, int a) {
    while (parent[a] != a) {
        parent[a] = parent[parent[a]];
        a = parent[a];
    }
    return a;
}

// generate_maze for one env: grid (AD * AD, AD = max_dim + 2, [y][x]) and
// free_cells (max_dim^2) are written whole; returns the free-cell count.
// Needs 0 <= md <= max_dim <= MAX_DIM (md is clamped to that range, so
// that a row outside it writes only inside its own arrays).
MZ_HD int32_t generate_env(Draws& rs, int md, int max_dim, int wall_obj,
                           int space_obj, int32_t* grid, int32_t* free_cells) {
    const int AD = max_dim + 2;
    md = md < 0 ? 0 : (md > max_dim ? max_dim : md);
    for (int i = 0; i < AD * AD; i++) grid[i] = wall_obj;
    for (int i = 0; i < max_dim * max_dim; i++) free_cells[i] = 0;
    grid[AD + 1] = 0;  // cell (0, 0) (mazegen.cpp:119)

    const int n_odd = md > 1 ? (md - 1) / 2 : 0;  // odd i with 0 < i < md - 1
    const int n_even = (md + 1) / 2;              // even j < md
    const int n_vert = n_odd * n_even;
    const int n_walls = 2 * n_vert;

    uint32_t alive[WORDS];
#pragma unroll
    for (int w = 0; w < WORDS; w++) {
        int left = n_walls - 32 * w;
        alive[w] = left >= 32 ? ~0u : (left > 0 ? (1u << left) - 1u : 0u);
    }
    uint8_t parent[HALF * HALF];
    for (int i = 0; i < n_even * n_even; i++) parent[i] = (uint8_t)i;

    int32_t nf = 0;
    for (int k = 0; k < n_walls; k++) {
        int r = rs.randn(n_walls - k);
        // the r-th surviving wall: its word, then its bit
        int word = 0;
        uint32_t bits = 0;
        bool found = false;
#pragma unroll
        for (int w = 0; w < WORDS; w++) {
            int c = popc(alive[w]);
            bool here = !found && r < c;
            word = here ? w : word;
            bits = here ? alive[w] : bits;
            r = (found || here) ? r : r - c;
            found = found || here;
        }
        int bit = nth_set_bit(bits, r);
#pragma unroll
        for (int w = 0; w < WORDS; w++)
            if (w == word) alive[w] &= ~(1u << bit);
        int wi = 32 * word + bit;

        int x1, y1, x2, y2;
        if (wi < n_vert) {  // (i - 1, j, i + 1, j), i odd, j even
            int i = 2 * (wi / n_even) + 1, j = 2 * (wi % n_even);
            x1 = i - 1; y1 = j; x2 = i + 1; y2 = j;
        } else {  // (i, j - 1, i, j + 1), i even, j odd
            int v = wi - n_vert;
            int i = 2 * (v / n_odd), j = 2 * (v % n_odd) + 1;
            x1 = i; y1 = j - 1; x2 = i; y2 = j + 1;
        }
        int x0 = (x1 + x2) / 2, y0 = (y1 + y2) / 2;
        int r0 = find_root(parent, (y1 / 2) * n_even + x1 / 2);
        int r1 = find_root(parent, (y2 / 2) * n_even + x2 / 2);
        if (grid[(y0 + 1) * AD + x0 + 1] == wall_obj && r0 != r1) {
            const int xs[3] = {x1, x0, x2}, ys[3] = {y1, y0, y2};
            for (int c = 0; c < 3; c++) {
                int32_t* g = grid + (ys[c] + 1) * AD + xs[c] + 1;
                if (*g != space_obj) free_cells[nf++] = md * ys[c] + xs[c];
                *g = space_obj;
            }
            parent[r0] = (uint8_t)r1;  // set s0 joins s1
        }
    }
    return nf;
}

MZ_HD int floor_div(int a, int b) {
    int q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// place_objects for one env, in place on its grid and free_cells rows:
// objects start_obj + j on distinct free cells other than the agent's
// (cell 0), each drawn, then redrawn at most max_tries times while it
// lands on a taken cell (-1) or on cell 0.
MZ_HD void place_env(Draws& rs, int md, int max_dim, int32_t nf, int start_obj,
                     int num_objs, int max_tries, int32_t* grid, int32_t* free_cells) {
    const int AD = max_dim + 2, NC = max_dim * max_dim;
    for (int j = 0; j < num_objs; j++) {
        int m = rs.randn(nf);
        for (int t = 0; t < max_tries; t++) {
            int v = free_cells[m < 0 ? 0 : (m > NC - 1 ? NC - 1 : m)];
            if (v != -1 && v != 0) break;
            m = rs.randn(nf);
        }
        int idx = m < 0 ? 0 : (m > NC - 1 ? NC - 1 : m);
        int cell = free_cells[idx];
        free_cells[idx] = -1;
        if (md <= 0) continue;
        int cy = floor_div(cell, md);
        int cx = cell - cy * md + 1;  // Python's cell % md, plus the offset
        cy += 1;
        if (cy >= 0 && cy < AD && cx >= 0 && cx < AD) grid[cy * AD + cx] = start_obj + j;
    }
}

}  // namespace mazegen
