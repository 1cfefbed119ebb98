// Host build of miner's gravity sweep (miner_sweep.cuh), a loop over envs
// with the kernel's arguments, each grid staged in bytes as the kernel
// stages it in shared memory, so that the CPU tests hold the kernel's
// logic against the plain version (procgen_torch/games/miner.py,
// gravity_sweep_ref).  Built with g++; not on any main path.
#include <cstdint>
#include <vector>

#include "miner_sweep.cuh"

extern "C" int miner_sweep_host(const int32_t* grid_in, const int32_t* agent_fall,
                                const int64_t* agent_free, int N, int W, int32_t* grid_out,
                                int32_t* diamonds, bool* crushed) {
    const int area = W * W;
    std::vector<uint8_t> g(area);
    for (int b = 0; b < N; b++) {
        const int32_t* src = grid_in + (int64_t)b * area;
        int32_t* dst = grid_out + (int64_t)b * area;
        for (int c = 0; c < area; c++) g[c] = (uint8_t)src[c];
        bool crush;
        diamonds[b] = miner_sweep::sweep_env(g.data(), 1, W, agent_fall[b], agent_free[b], &crush);
        crushed[b] = crush;
        for (int c = 0; c < area; c++) dst[c] = g[c];
    }
    return 0;
}

// The object codes compiled in: BOULDER, DIAMOND, MOVING_BOULDER,
// MOVING_DIAMOND, SPACE.
extern "C" void miner_sweep_codes(int32_t* out) {
    using namespace miner_sweep;
    const int32_t codes[] = {BOULDER, DIAMOND, MOVING_BOULDER, MOVING_DIAMOND, SPACE};
    for (int i = 0; i < 5; i++) out[i] = codes[i];
}
