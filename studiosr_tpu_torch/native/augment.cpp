// Native host-side data-path kernels for the training input pipeline.
//
// A copy of the JAX package's native/augment.cpp. The input pipeline's
// crop/flip/rot90/normalize work runs on host CPUs and contends with the
// dispatch thread under the GIL. These C++ kernels do the per-sample
// augmentation + uint8->float32 conversion in one cache-friendly pass and
// are called through ctypes (which releases the GIL), so data-loader threads
// scale across cores.
//
// Semantics are bit-identical to the numpy pipeline in
// studiosr_tpu_torch/data/transforms.py: crop at (ys, xs), optional fliplr,
// then flipud, then a single CCW rot90 (numpy order), then /255
// normalization. Unlike the JAX package's copy, which multiplies by 1/255
// (within 1 ulp), it divides by 255 as numpy does, so the bits are numpy's.
// Validated against the numpy path in tests/test_torch_native.py.

#include <cstdint>
#include <cstddef>

namespace {

// Map output pixel (i, j) of an S x S augmented crop back to source
// coordinates inside the crop. Transforms are applied in pipeline order
// (fliplr -> flipud -> rot90), so we invert them in reverse.
inline void source_index(int i, int j, int size, int flags, int &si, int &sj) {
    // Inverse of rot90 (CCW): out[i][j] = in[j][S-1-i].
    if (flags & 4) {
        int ti = j, tj = size - 1 - i;
        i = ti; j = tj;
    }
    // Inverse of flipud: out[i][j] = in[S-1-i][j].
    if (flags & 2) i = size - 1 - i;
    // Inverse of fliplr: out[i][j] = in[i][S-1-j].
    if (flags & 1) j = size - 1 - j;
    si = i; sj = j;
}

void crop_one(const uint8_t *img, int stride_row, int xs, int ys, int size,
              int flags, float *out) {
    for (int i = 0; i < size; ++i) {
        float *dst = out + (size_t)i * size * 3;
        for (int j = 0; j < size; ++j) {
            int si, sj;
            source_index(i, j, size, flags, si, sj);
            const uint8_t *src = img + (size_t)(ys + si) * stride_row + (size_t)(xs + sj) * 3;
            dst[j * 3 + 0] = src[0] / 255.0f;
            dst[j * 3 + 1] = src[1] / 255.0f;
            dst[j * 3 + 2] = src[2] / 255.0f;
        }
    }
}

}  // namespace

extern "C" {

// Paired crop + augment + normalize for one (lq, gt) sample.
//   lq: (lh, lw, 3) uint8;  gt: (lh*scale, lw*scale, 3) uint8
//   crop: lq (ys, xs, size); gt (ys*scale, xs*scale, size*scale)
//   flags: bit0 fliplr, bit1 flipud, bit2 rot90 (CCW), applied in that order
//   out_lq: (size, size, 3) float32 in [0,1]; out_gt likewise at size*scale
void paired_crop_augment(const uint8_t *lq, int lh, int lw,
                         const uint8_t *gt, int size, int scale,
                         int xs, int ys, int flags,
                         float *out_lq, float *out_gt) {
    (void)lh;
    crop_one(lq, lw * 3, xs, ys, size, flags, out_lq);
    crop_one(gt, lw * scale * 3, xs * scale, ys * scale, size * scale, flags, out_gt);
}

}  // extern "C"
