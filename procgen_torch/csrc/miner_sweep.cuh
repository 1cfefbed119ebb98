// Miner's gravity sweep for one env (reference procgen/src/games/miner.cpp:
// 267-303), shared by the CUDA kernel of miner_sweep.cu (one thread per
// env, the grid staged in shared memory) and the host build of
// miner_sweep_host.cpp (a loop over envs, for the CPU tests).  The plain
// version is procgen_torch/games/miner.py (MinerGame.gravity_sweep_ref);
// this function writes the same grid, count and flag:
//
// * cells in ascending order (row 0 at the bottom), each updated in place:
//   a fall writes the already swept row below, a roll writes the neighbour
//   not yet swept (right) or the one just swept (left);
// * a cell is read once, when its turn comes ("seen"): a boulder or
//   diamond, moving or not, settles, falls, rolls or crushes the agent;
// * the falling check reads the agent's cell from its float position
//   (agent_fall), the roll's is_free test excludes get_agent_index()
//   (agent_free); the wrapper computes both as the plain version does;
// * the crush branch leaves the cell as it is; row 0 has the OOB wall
//   below it, so nothing falls, crushes or rolls there;
// * the count of diamonds is over the seen values whose settled form is
//   DIAMOND.
//
// Cell values are object codes 0..SPACE, held in a byte each.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define MS_HD __host__ __device__ __forceinline__
#else
#define MS_HD inline
#endif

namespace miner_sweep {

// procgen_torch/games/miner.py and procgen_torch/objects.py (a test pins
// them through the host build's miner_sweep_codes)
constexpr int BOULDER = 1;
constexpr int DIAMOND = 2;
constexpr int MOVING_BOULDER = 3;
constexpr int MOVING_DIAMOND = 4;
constexpr int SPACE = 100;

MS_HD bool is_moving(int v) { return v == MOVING_BOULDER || v == MOVING_DIAMOND; }

MS_HD bool is_round(int v) { return v == BOULDER || v == DIAMOND || is_moving(v); }

// the settled form of a value
MS_HD int settled(int v) {
    return v == MOVING_BOULDER ? BOULDER : v == MOVING_DIAMOND ? DIAMOND : v;
}

// the moving form of a settled boulder or diamond
MS_HD int falling(int v) {
    return v == BOULDER ? MOVING_BOULDER : v == DIAMOND ? MOVING_DIAMOND : v;
}

// Sweeps one env's grid of W x W cells, cell i at g[i * stride].  Returns
// the count of diamonds; sets *crushed when a moving object lands on the
// agent.
MS_HD int32_t sweep_env(uint8_t* g, int stride, int W, int64_t agent_fall,
                        int64_t agent_free, bool* crushed) {
    const int area = W * W;
    int32_t diamonds = 0;
    bool crush = false;
    for (int idx = 0, x = 0; idx < area; idx++, x = x + 1 == W ? 0 : x + 1) {
        const int obj = g[idx * stride];
        const int stat = settled(obj);
        diamonds += stat == DIAMOND;
        if (!is_round(obj)) continue;  // left as it is
        const int below = idx - W;
        if (below < 0) {  // the OOB wall below
            g[idx * stride] = (uint8_t)stat;
            continue;
        }
        const int obj2 = g[below * stride];
        const bool agent_below = below == agent_fall;
        if (obj2 == SPACE && !agent_below) {  // fall
            g[idx * stride] = (uint8_t)SPACE;
            g[below * stride] = (uint8_t)falling(obj);
            continue;
        }
        if (agent_below && is_moving(obj)) {  // crush: the cell stays
            crush = true;
            continue;
        }
        int to = idx;  // where the settled object ends up
        if (is_round(obj2)) {
            // is_free: SPACE and not the agent's cell, read before any write
            // of this cell's turn
            auto is_free = [&](int i) { return g[i * stride] == SPACE && i != agent_free; };
            if (x > 0 && is_free(idx - 1) && is_free(below - 1)) {
                to = idx - 1;
            } else if (x < W - 1 && is_free(idx + 1) && is_free(below + 1)) {
                to = idx + 1;
            }
        }
        if (to != idx) g[idx * stride] = (uint8_t)SPACE;
        g[to * stride] = (uint8_t)stat;
    }
    *crushed = crush;
    return diamonds;
}

}  // namespace miner_sweep
