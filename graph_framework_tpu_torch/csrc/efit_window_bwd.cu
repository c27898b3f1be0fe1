// The C interface of the window backward and K2's float instantiation
// (kernels in efit_window_bwd.cuh).

#include "efit_window_bwd.cuh"

namespace gft {

template int launch_bwd<float, false>(const BwdArgs&);

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// Pull the cotangent of one plain window's output back to its input, for n
// rays and `steps` substeps.
//   dtype: 0 = float, 1 = double;  method: 2 = rk2, 4 = rk4;
//   state_in: the window's 8 input arrays (t w x y z kx ky kz);
//   ct_in: the 8 output cotangents;  ct_out: the 8 input cotangents;
//   psi, prof, params: as gft_efit_window;
//   dpsi, dprof: null for K2; for K3 two (16, n) arrays (coefficient-major)
//     that receive each ray's psi- and profile-block cotangents, and cell,
//     pcell two (n,) int64 arrays that receive the table rows of its blocks
//     (all four null, or none).
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_efit_window_bwd(int dtype, int method, int steps,
                                   long long n, void** state_in,
                                   void** ct_in, void** ct_out,
                                   const void* psi, int nr, int nz,
                                   const void* prof, int npsi,
                                   const double* params, void* dpsi,
                                   void* dprof, void* cell, void* pcell,
                                   void* stream) {
  const int given = (dpsi != nullptr) + (dprof != nullptr) +
                    (cell != nullptr) + (pcell != nullptr);
  if (gft::bad_window_args(steps, n, method, nr, nz, npsi) ||
      (given != 0 && given != 4))
    return gft::kInvalidArgument;
  if (n == 0) return 0;
  const gft::BwdArgs a{method, steps, n, state_in, ct_in, ct_out, psi, nr,
                       nz, prof, npsi, params, dpsi, dprof, cell, pcell,
                       static_cast<cudaStream_t>(stream)};
  const bool tab = given == 4;
  if (dtype == 0)
    return tab ? gft::launch_bwd<float, true>(a)
               : gft::launch_bwd<float, false>(a);
  if (dtype == 1)
    return tab ? gft::launch_bwd<double, true>(a)
               : gft::launch_bwd<double, false>(a);
  return gft::kInvalidArgument;
}
