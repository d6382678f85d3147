// csrc/rays.cu's frame rays on the host, for tools/host_rays.py: built by
// a host C++ compiler against the cuda_runtime.h beside this file.  Runs
// the kernel's rays_group over every group of pixels of the frame, one
// after another, with the argument the kernel takes (RayArgs); the kernel
// itself and its launch are for nvcc only.
#include "rays.cu"

// pwnfps_frame_rays's frame on the host; 0, or 1 for an argument the
// kernel's entry refuses
extern "C" int pwnfps_host_frame_rays(const void* args) {
    const RayArgs& a = *(const RayArgs*)args;
    if (bad_args(a)) return 1;
    const unsigned groups = (unsigned)a.height * groups_a_row(a);
    for (unsigned g = 0; g < groups; ++g) rays_group(a, g);
    return 0;
}
