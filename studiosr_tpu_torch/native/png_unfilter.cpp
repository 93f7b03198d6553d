// PNG row unfiltering for utils/png.py, called through ctypes (which
// releases the GIL, so the loader's threads decode in parallel).
//
// Undoes the five row filters of the PNG specification (section 9): None,
// Sub, Up, Average and Paeth, byte for byte what png.py's plain version
// computes. Average and Paeth depend on the byte just rebuilt to their left,
// which is why a numpy row operation cannot do them and this loop exists.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: height rows of (1 + stride) bytes, the filter type then the filtered
// bytes; out: height x stride unfiltered bytes; bpp: bytes per pixel.
// Returns 0, or 1 + the index of the first row whose filter type is not 0-4
// (rows before it are unfiltered).
int png_unfilter(const uint8_t *raw, int height, int stride, int bpp, uint8_t *out) {
    for (int y = 0; y < height; ++y) {
        const uint8_t *row = raw + (size_t)y * (stride + 1);
        const uint8_t *line = row + 1;
        uint8_t *cur = out + (size_t)y * stride;
        const uint8_t *prior = y > 0 ? cur - stride : nullptr;
        switch (row[0]) {
        case 0:
            for (int i = 0; i < stride; ++i) cur[i] = line[i];
            break;
        case 1:
            for (int i = 0; i < stride; ++i) cur[i] = (uint8_t)(line[i] + (i >= bpp ? cur[i - bpp] : 0));
            break;
        case 2:
            for (int i = 0; i < stride; ++i) cur[i] = (uint8_t)(line[i] + (prior ? prior[i] : 0));
            break;
        case 3:
            for (int i = 0; i < stride; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prior ? prior[i] : 0;
                cur[i] = (uint8_t)(line[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int i = 0; i < stride; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prior ? prior[i] : 0;
                int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
                int p = a + b - c;
                int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[i] = (uint8_t)(line[i] + pred);
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}

}  // extern "C"
