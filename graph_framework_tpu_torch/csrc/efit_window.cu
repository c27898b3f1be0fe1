// K1's C interface and its cold-plasma instantiations (the kernel template is
// in efit_window.cuh; every other dispersion's instantiations in
// efit_window_<tail>.cu).

#include "efit_window.cuh"

namespace gft {

template int launch<ColdPlasma, float>(GFT_WINDOW_LAUNCH_ARGS);
template int launch<ColdPlasma, double>(GFT_WINDOW_LAUNCH_ARGS);

}  // namespace gft

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes by kernels/build.py)
// ---------------------------------------------------------------------------

// Advance n rays through one freeze window of `steps` substeps.
//   dtype: 0 = float, 1 = double;  disp: the dispersion's code
//     (GFT_DISPERSIONS, efit_adjoint.cuh);  method: 2 = rk2, 4 = rk4;
//   compensated: 0/1 (8 or 16 state arrays in state_in/state_out, in the
//     order t w x y z kx ky kz, then the 8 low words);
//   psi: (nr*nz, 16) cell-major bicubic table; prof: (npsi, 16) profiles;
//   params: rmin dr zmin dz psimin dpsi ne_scale te_scale kpe kce kpi kci dt
//     pres_scale kvt kvs kvs3 (efit_common.cuh Params).
// Launches on `stream` and returns at once: 0, a cudaError_t from the
// launch, or -1 for an argument the kernel does not take.
extern "C" int gft_efit_window(int dtype, int disp, int method,
                               int compensated, int steps, long long n,
                               void** state_in, void** state_out,
                               const void* psi, int nr, int nz,
                               const void* prof, int npsi,
                               const double* params, void* stream) {
  if (gft::bad_window_args(steps, n, method, nr, nz, npsi) ||
      (compensated != 0 && compensated != 1) || (dtype != 0 && dtype != 1))
    return gft::kInvalidArgument;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GFT_LAUNCH(D)                                                       \
  (dtype == 0 ? gft::launch<gft::D, float>(method, compensated, steps, n,  \
                                           state_in, state_out, psi, nr,   \
                                           nz, prof, npsi, params, st)     \
              : gft::launch<gft::D, double>(method, compensated, steps, n, \
                                            state_in, state_out, psi, nr,  \
                                            nz, prof, npsi, params, st))
#define GFT_CASE(code, D) \
  case code:              \
    return GFT_LAUNCH(D);
  switch (disp) {
    GFT_DISPERSIONS(GFT_CASE)
    default: return gft::kInvalidArgument;
  }
#undef GFT_CASE
#undef GFT_LAUNCH
}

extern "C" const char* gft_error_string(int code) {
  if (code == gft::kInvalidArgument)
    return "invalid argument to a gft kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
