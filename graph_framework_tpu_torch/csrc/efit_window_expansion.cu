// K1's instantiations for models/dispersion.py cold_plasma_expansion; the kernel template
// is in efit_window.cuh, the C interface in efit_window.cu.

#include "efit_window.cuh"

namespace gft {

template int launch<ColdPlasmaExpansion, float>(GFT_WINDOW_LAUNCH_ARGS);
template int launch<ColdPlasmaExpansion, double>(GFT_WINDOW_LAUNCH_ARGS);

}  // namespace gft
