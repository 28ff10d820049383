// Native (C++) fast path for per-sample label construction: the port's
// copy of the JAX package's native/labeling.cpp, the same source.
//
// The host-side data pipeline (the feed_dict producer, reference
// lib/dataset.py:251-554) builds every frame's labels; this library
// implements the per-point labeling math of data/labeling.py
// (NOCS/NAOCS normalization, joint offset heatmaps/unit vectors/
// association, one-hot masks) as a single O(num_points · joints) pass,
// exposed over a plain C ABI for ctypes.
//
// Semantics mirror data/labeling.py::build_sample exactly (which in turn
// mirrors reference lib/dataset.py:490-547); parity is pinned by
// tests/test_torch_native.py.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline void nocs_normalize(const double* c0, const double* c1, double f,
                           const double* p, double* out) {
  // (p - c0)*f + 0.5 - 0.5*(c1-c0)*f  (lib/dataset.py:494)
  for (int k = 0; k < 3; ++k) {
    out[k] = (p[k] - c0[k]) * f + 0.5 - 0.5 * (c1[k] - c0[k]) * f;
  }
}

inline void point_line_offset(const double* P0, const double* l,
                              const double* p, double* out) {
  // (P0P·l) l/|l|^2 - P0P  (lib/d3_utils.py:192-203)
  double v[3] = {p[0] - P0[0], p[1] - P0[1], p[2] - P0[2]};
  double ll = l[0] * l[0] + l[1] * l[1] + l[2] * l[2];
  if (ll < 1e-12) ll = 1e-12;
  double dot = (v[0] * l[0] + v[1] * l[1] + v[2] * l[2]) / ll;
  for (int k = 0; k < 3; ++k) out[k] = dot * l[k] - v[k];
}

}  // namespace

extern "C" {

// Builds all per-point labels for one frame.
//
// Inputs (all row-major):
//   pts        (n_total, 3) camera-space points, parts concatenated
//   canon      (n_total, 3) canonical coords, same order
//   part_of    (n_total)    part index of each row
//   corners    (n_parts+1, 2, 3) boxes: [0]=global, [j+1]=part j
//   factors    (n_parts+1)  1/diagonal factors
//   joints     n_joints x {pos(3), axis(3) unit, parent, child, type}
//              type: 0=revolute, 1=prismatic, 2=fixed
//   sel        (num_points) row indices to emit (tiling handled by caller
//              via modular indices; permutation by caller's RNG)
// Outputs:
//   P          (num_points, 3)  = pts[sel] * factors[0]
//   cls        (num_points)
//   mask       (num_points, n_max_parts) one-hot
//   nocs       (num_points, 3) part NOCS
//   nocs_g     (num_points, 3) global NAOCS
//   heat/jcls/jmask (num_points), unit/orient (num_points, 3)
//   joint_params (n_max_parts, 7)
int ancsh_build_labels(
    const float* pts, const float* canon, const int32_t* part_of,
    int32_t n_total, int32_t n_parts,
    const double* corners, const double* factors,
    const double* joint_pos, const double* joint_axis,
    const int32_t* joint_parent, const int32_t* joint_child,
    const int32_t* joint_type, int32_t n_joints,
    double thres_r, const int32_t* sel, int32_t num_points,
    int32_t n_max_parts,
    float* P, float* cls, float* mask, float* nocs, float* nocs_g,
    float* heat, float* unitv, float* orient, float* jcls, float* jmask,
    float* joint_params) {
  if (n_parts > n_max_parts || n_joints > 15) return 1;

  const double* gc0 = corners;              // global box min corner
  const double* gc1 = corners + 3;
  const double gf = factors[0];

  // joint lines in global NOCS + the 7-dof params (lib/dataset.py:499-506)
  double jP0[16][3], jL[16][3];
  std::memset(joint_params, 0, sizeof(float) * n_max_parts * 7);
  for (int k = 0; k < n_joints; ++k) {
    nocs_normalize(gc0, gc1, gf, joint_pos + 3 * k, jP0[k]);
    double norm = 0.0;
    for (int c = 0; c < 3; ++c) norm += joint_axis[3 * k + c] * joint_axis[3 * k + c];
    norm = std::sqrt(norm);
    if (norm < 1e-12) norm = 1e-12;
    for (int c = 0; c < 3; ++c) jL[k][c] = joint_axis[3 * k + c] / norm;
    int slot = k + 1 < n_max_parts ? k + 1 : n_max_parts - 1;
    double origin[3] = {0.0, 0.0, 0.0};
    double orth[3];
    point_line_offset(jP0[k], jL[k], origin, orth);
    double d = std::sqrt(orth[0] * orth[0] + orth[1] * orth[1] + orth[2] * orth[2]);
    for (int c = 0; c < 3; ++c) joint_params[slot * 7 + c] = (float)jL[k][c];
    joint_params[slot * 7 + 6] = (float)d;
    double dd = d < 1e-8 ? 1e-8 : d;
    for (int c = 0; c < 3; ++c) joint_params[slot * 7 + 3 + c] = (float)(orth[c] / dd);
  }

  // per-part joint membership (parent joint + child joints)
  // bitmask over joints for each part
  uint32_t part_joints[64];
  std::memset(part_joints, 0, sizeof(part_joints));
  for (int k = 0; k < n_joints; ++k) {
    if (joint_child[k] >= 0 && joint_child[k] < n_parts)
      part_joints[joint_child[k]] |= (1u << k);
    if (joint_parent[k] >= 0 && joint_parent[k] < n_parts)
      part_joints[joint_parent[k]] |= (1u << k);
  }

  std::memset(mask, 0, sizeof(float) * num_points * n_max_parts);

  for (int i = 0; i < num_points; ++i) {
    const int32_t r = sel[i] % n_total;  // caller may pass tiled indices
    const int j = part_of[r];
    const double p_cam[3] = {pts[3 * r], pts[3 * r + 1], pts[3 * r + 2]};
    const double p_can[3] = {canon[3 * r], canon[3 * r + 1], canon[3 * r + 2]};

    for (int c = 0; c < 3; ++c) P[3 * i + c] = (float)(p_cam[c] * gf);
    cls[i] = (float)j;
    mask[i * n_max_parts + j] = 1.0f;

    double out[3];
    nocs_normalize(corners + 6 * (j + 1), corners + 6 * (j + 1) + 3,
                   factors[j + 1], p_can, out);
    for (int c = 0; c < 3; ++c) nocs[3 * i + c] = (float)out[c];
    double g[3];
    nocs_normalize(gc0, gc1, gf, p_can, g);
    for (int c = 0; c < 3; ++c) nocs_g[3 * i + c] = (float)g[c];

    // joint labels: last matching joint wins, matching the python loop
    // over offsets (lib/dataset.py:535-547 writes in joint order)
    float h = 0.f, uv[3] = {0, 0, 0}, orv[3] = {0, 0, 0}, jc = 0.f;
    for (int k = 0; k < n_joints; ++k) {
      if (!(part_joints[j] & (1u << k))) continue;
      if (joint_type[k] == 2) continue;  // fixed
      double off[3];
      double hm;
      if (joint_type[k] == 1) {          // prismatic: constant mid labels
        off[0] = off[1] = off[2] = 0.5 * thres_r;
        hm = std::sqrt(3.0) * 0.5 * thres_r;
        if (!(hm > 0)) continue;
      } else {
        point_line_offset(jP0[k], jL[k], g, off);
        hm = std::sqrt(off[0] * off[0] + off[1] * off[1] + off[2] * off[2]);
        if (!(hm < thres_r)) continue;
      }
      h = (float)(1.0 - hm / thres_r);
      const double denom = hm + 1e-8;
      for (int c = 0; c < 3; ++c) uv[c] = (float)(off[c] / denom);
      for (int c = 0; c < 3; ++c) orv[c] = (float)jL[k][c];
      jc = (float)(k + 1);
    }
    heat[i] = h;
    for (int c = 0; c < 3; ++c) unitv[3 * i + c] = uv[c];
    for (int c = 0; c < 3; ++c) orient[3 * i + c] = orv[c];
    jcls[i] = jc;
    jmask[i] = jc > 0 ? 1.0f : 0.0f;
  }
  return 0;
}

}  // extern "C"
