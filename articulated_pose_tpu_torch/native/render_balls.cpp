// Native (C++) point-cloud ball rasterizer: a copy of
// articulated_pose_tpu/native/render_balls.cpp, built with labeling.cpp
// into one library (native/__init__.py).
//
// Equivalent of the reference's ctypes viewer backend
// (pointnet_plusplus/utils/show3d_balls.py:23,76 — whose C source is
// absent upstream; only a prebuilt render_balls_so binary ships).  This
// is a fresh implementation: z-buffered sphere splatting with Lambert
// shading, orthographic screen-space input.  The Python side
// (utils/ball_viewer.py) does normalization/rotation/projection and has
// a NumPy implementation of the same algorithm; the two are held equal
// by tests/test_torch_aux.py.

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// image: h*w*3 uint8, pre-filled with the background color.
// xyz:   n*3 int32 screen coordinates (row, col, depth); depth grows
//        toward the viewer (larger z wins).
// r,g,b: n float32 per-point colors in [0,255].
// radius: ball radius in pixels (>=1).
int ancsh_render_balls(int h, int w, uint8_t* image, int n,
                       const int32_t* xyz, const float* r, const float* g,
                       const float* b, int radius) {
  if (h <= 0 || w <= 0 || n < 0 || radius < 1) return 1;

  // Disk template: pixel offsets within the ball plus the sphere height
  // dz = sqrt(R^2 - dx^2 - dy^2) used both for depth and shading.
  struct Texel {
    int dx, dy;
    float dz;     // sphere height above the splat plane
    float shade;  // Lambert-ish intensity in [0.3, 1.0]
  };
  std::vector<Texel> disk;
  disk.reserve((2 * radius + 1) * (2 * radius + 1));
  const float R2 = float(radius) * float(radius);
  for (int dx = -radius; dx <= radius; ++dx) {
    for (int dy = -radius; dy <= radius; ++dy) {
      float d2 = float(dx * dx + dy * dy);
      if (d2 > R2) continue;
      float dz = std::sqrt(R2 - d2);
      disk.push_back({dx, dy, dz, 0.3f + 0.7f * dz / float(radius)});
    }
  }

  // Depth buffer: camera looks down -z in screen space, so larger
  // (z + dz) is closer and wins.
  std::vector<float> zbuf(size_t(h) * size_t(w),
                          -std::numeric_limits<float>::infinity());
  for (int i = 0; i < n; ++i) {
    const int cx = xyz[3 * i + 0];
    const int cy = xyz[3 * i + 1];
    const float cz = float(xyz[3 * i + 2]);
    for (const Texel& t : disk) {
      const int x = cx + t.dx;
      const int y = cy + t.dy;
      if (x < 0 || x >= h || y < 0 || y >= w) continue;
      const size_t pix = size_t(x) * size_t(w) + size_t(y);
      // >= so equal depths resolve to the later point — the same order
      // the NumPy fallback's stable painter's sort produces.
      const float depth = cz + t.dz;
      if (depth < zbuf[pix]) continue;
      zbuf[pix] = depth;
      const float rr = r[i] * t.shade;
      const float gg = g[i] * t.shade;
      const float bb = b[i] * t.shade;
      image[3 * pix + 0] = uint8_t(rr < 0 ? 0 : (rr > 255 ? 255 : rr));
      image[3 * pix + 1] = uint8_t(gg < 0 ? 0 : (gg > 255 ? 255 : gg));
      image[3 * pix + 2] = uint8_t(bb < 0 ? 0 : (bb > 255 ? 255 : bb));
    }
  }
  return 0;
}

}  // extern "C"
