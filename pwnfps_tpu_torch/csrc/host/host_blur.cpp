// csrc/blur.cu's blur on the host, one tile after another, for
// tools/host_blur.py: built by a host C++ compiler against the
// cuda_runtime.h beside this file.  Each tw x th tile takes its reach
// over its pixels, stages its window where the kernel's instance of
// that tile does (stages_window, window_of, stage) and blurs its
// pixels (taps_of, window_blur, and mixed_blur for a pixel with a tap
// outside the window) through the functions the kernel calls; the kernel
// itself, its reduction and its launch are for nvcc only.  stats, where
// not null, receives: tiles that staged a window, tiles that did not,
// taps read from a window (of them, on its first or last row or
// column), and taps of staged tiles read from global memory.
#include <vector>

#include "blur.cu"

dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace {

int run(const Form& f, int tw, int th, long long* stats) {
    if ((th != 16 && th != 32) || (tw != 32 && tw != 64)) return 1;
    std::vector<int32_t> win(window_words(tw, th) + 1);
    long long st[5] = {0, 0, 0, 0, 0};
    const int wx = 4 * (f.w / 4);
    const int per = (f.unit_rows + th - 1) / th;
    for (int t = 0; t < f.units * per; ++t) {
        for (int bx = 0; bx * tw < f.w; ++bx) {
            const Tile k = tile_of(f, tw, th, t, bx);
            const int32_t* src = f.fb + (size_t)k.unit * f.src_rows * f.w;
            const size_t orow = (size_t)k.unit * f.unit_rows + k.lr0;
            const int x1 = std::min(k.x0 + tw, f.w);
            float m = 0.0f;
            for (int lr = 0; lr < k.nr; ++lr)
                for (int x = k.x0; x < std::min(x1, wx); ++x)
                    m = fmaxf(m, fabsf(__fsub_rn(
                        f.zbuf[(orow + lr) * f.w + x], 1.0f)));
            const Window v = stages_window(tw, th)
                ? window_of(f, k, __fmul_rn(f.fstr, m))
                : Window{0, 0, 0, 0, tw + 2 * RCAP};
            st[v.wh > 0 ? 0 : 1] += 1;
            stage(f, src, v, win.data(), 0, 1, 0, 1);
            for (int lr = 0; lr < k.nr; ++lr) {
                const int fy = f.yoff + k.lr0 + lr;
                for (int x = k.x0; x < x1; ++x) {
                    const size_t p = (orow + lr) * f.w + x;
                    if (x >= wx) {
                        f.out[p] = src[(size_t)(f.soff + k.lr0 + lr) * f.w + x];
                        continue;
                    }
                    uint32_t t16[16];
                    for (int j = 0; j < 16; ++j)
                        t16[j] = (uint32_t)f.tab[j * f.w + x];
                    const float z = __fsub_rn(f.zbuf[p], 1.0f);
                    const Taps tp = taps_of(f, t16, x, fy, z);
                    bool ok = false;
                    uint32_t word = 0;
                    if (v.wh > 0) word = window_blur(v, win.data(), tp, ok);
                    if (!ok) word = mixed_blur(f, src, v, win.data(), tp);
                    f.out[p] = (int32_t)word;
                    if (v.wh == 0) continue;
                    for (int i = 0; i < 4; ++i) {
                        const int sr = tp.sr[i], c = tp.c[i];
                        if (!in_window(v, sr, c)) {
                            st[4] += 1;
                        } else {
                            st[2] += 1;
                            st[3] += sr == v.s0 || sr == v.s0 + v.wh - 1 ||
                                     c == v.c0 || c == v.c0 + v.ww - 1;
                        }
                    }
                }
            }
        }
    }
    if (stats)
        for (int i = 0; i < 5; ++i) stats[i] = st[i];
    return 0;
}

}  // namespace

// pwnfps_dof_blur's pass in tw x th tiles; 0, or 1 for a tile the
// kernel has no instance of
extern "C" int pwnfps_host_blur(const void* fb, const void* zbuf,
                                const void* tab, void* out, int rows, int w,
                                int frame_h, float fstr, float inv_mod,
                                int tw, int th, long long* stats) {
    if (rows <= 0 || w <= 0 || frame_h <= 0 || rows % frame_h != 0 ||
        w > kMaxSide || frame_h > kMaxSide)
        return 1;
    return run(frame_form(fb, zbuf, tab, out, rows, w, frame_h, fstr,
                          inv_mod), tw, th, stats);
}

// pwnfps_dof_blur_band's pass in tw x th tiles
extern "C" int pwnfps_host_blur_band(const void* fb_pad, const void* zb,
                                     const void* tab, void* out, int cl,
                                     int hb, int halo, int w, int y0, int fh,
                                     float fstr, float inv_mod, int tw,
                                     int th, long long* stats) {
    if (cl <= 0 || hb <= 0 || halo < 0 || w <= 0 || y0 < 0 || fh <= 0 ||
        w > kMaxSide || fh > kMaxSide)
        return 1;
    return run(band_form(fb_pad, zb, tab, out, cl, hb, halo, w, y0, fh, fstr,
                         inv_mod), tw, th, stats);
}
