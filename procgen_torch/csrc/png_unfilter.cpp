// PNG scanline unfiltering (RFC 2083 section 6) for the host-side asset
// pipeline (procgen_torch/render/assets.py, through ctypes).  Takes the
// inflated IDAT stream (one filter byte + stride bytes per row) and writes
// the reconstructed image bytes.  Returns 0, or -1 on an unknown filter.
// Built with g++ on first use; a host function, not a device kernel.
#include <cstdint>
#include <cstdlib>
#include <cstring>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

extern "C" int png_unfilter(
    const uint8_t* raw, uint8_t* out, int h, int stride, int bpp) {
    for (int y = 0; y < h; y++) {
        const uint8_t* line = raw + (size_t)y * (stride + 1);
        uint8_t f = line[0];
        const uint8_t* src = line + 1;
        uint8_t* dst = out + (size_t)y * stride;
        const uint8_t* prior = y > 0 ? out + (size_t)(y - 1) * stride : nullptr;
        switch (f) {
            case 0:  // none
                memcpy(dst, src, stride);
                break;
            case 1:  // sub
                for (int x = 0; x < stride; x++) {
                    uint8_t left = x >= bpp ? dst[x - bpp] : 0;
                    dst[x] = (uint8_t)(src[x] + left);
                }
                break;
            case 2:  // up
                for (int x = 0; x < stride; x++) {
                    uint8_t up = prior ? prior[x] : 0;
                    dst[x] = (uint8_t)(src[x] + up);
                }
                break;
            case 3:  // average
                for (int x = 0; x < stride; x++) {
                    int left = x >= bpp ? dst[x - bpp] : 0;
                    int up = prior ? prior[x] : 0;
                    dst[x] = (uint8_t)(src[x] + ((left + up) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int x = 0; x < stride; x++) {
                    int left = x >= bpp ? dst[x - bpp] : 0;
                    int up = prior ? prior[x] : 0;
                    int ul = (x >= bpp && prior) ? prior[x - bpp] : 0;
                    dst[x] = (uint8_t)(src[x] + paeth(left, up, ul));
                }
                break;
            default:
                return -1;
        }
    }
    return 0;
}
