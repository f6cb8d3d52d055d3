/* Native episode assembly for the few-shot data loader.
 *
 * The role the reference delegates to torch's C++ DataLoader workers
 * (reference data.py:575-581): turning per-class image stores into episode
 * tensors fast enough to keep the accelerator fed. One call gathers the
 * sampled images of one class, applies the class-level k*90-degree rotation
 * (numpy.rot90 semantics, axes=(0,1)) and writes the result transposed to
 * CHW — the loader's augment+ToTensor step (reference data.py:17-77) in a
 * single pass with no intermediate copies.
 *
 * Plain C ABI, called through ctypes (which releases the GIL), so the
 * loader's synthesis threads scale across cores instead of serializing on
 * the interpreter.
 *
 * Layouts: src (S,H,W,C) float32 C-contiguous; idx (M,) int64;
 * dst (M,C,H,W) float32 C-contiguous. Requires H == W when k is odd
 * (all supported datasets use square images; the Python wrapper checks).
 */

#include <stdint.h>

static void gather_one(const float *src, int64_t H, int64_t W, int64_t C,
                       const int64_t *idx, int64_t M, int k, float *dst) {
    const int64_t img = H * W * C;
    k &= 3;
    for (int64_t m = 0; m < M; ++m) {
        const float *s = src + idx[m] * img;
        for (int64_t c = 0; c < C; ++c) {
            float *d = dst + (m * C + c) * H * W;
            switch (k) {
            case 0:
                for (int64_t i = 0; i < H; ++i)
                    for (int64_t j = 0; j < W; ++j)
                        d[i * W + j] = s[(i * W + j) * C + c];
                break;
            case 1: /* out[i][j] = in[j][n-1-i] */
                for (int64_t i = 0; i < H; ++i)
                    for (int64_t j = 0; j < W; ++j)
                        d[i * W + j] = s[(j * W + (W - 1 - i)) * C + c];
                break;
            case 2: /* out[i][j] = in[n-1-i][n-1-j] */
                for (int64_t i = 0; i < H; ++i)
                    for (int64_t j = 0; j < W; ++j)
                        d[i * W + j] = s[((H - 1 - i) * W + (W - 1 - j)) * C + c];
                break;
            default: /* k == 3: out[i][j] = in[n-1-j][i] */
                for (int64_t i = 0; i < H; ++i)
                    for (int64_t j = 0; j < W; ++j)
                        d[i * W + j] = s[((H - 1 - j) * W + i) * C + c];
                break;
            }
        }
    }
}

void gather_rot_chw(const float *src, int64_t H, int64_t W, int64_t C,
                    const int64_t *idx, int64_t M, int k, float *dst) {
    gather_one(src, H, W, C, idx, M, k, dst);
}

/* Whole-episode assembly: N classes in ONE call (ctypes marshalling per
 * call was ~2/3 of the per-class path's cost). src_ptrs holds the N
 * class-store base addresses as int64; idx is (N, M) sample indices; ks is
 * (N,) rotation quarter-turns; dst is (N, M, C, H, W) float32. */
void assemble_episode(const int64_t *src_ptrs, int64_t H, int64_t W,
                      int64_t C, const int64_t *idx, const int32_t *ks,
                      int64_t N, int64_t M, float *dst) {
    const int64_t cls = M * C * H * W;
    for (int64_t n = 0; n < N; ++n)
        gather_one((const float *)(intptr_t)src_ptrs[n], H, W, C,
                   idx + n * M, M, (int)ks[n], dst + n * cls);
}
