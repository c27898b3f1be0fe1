// K1's instantiations for models/dispersion.py bohm_gross; the kernel template
// is in efit_window.cuh, the C interface in efit_window.cu.

#include "efit_window.cuh"

namespace gft {

template int launch<BohmGross, float>(GFT_WINDOW_LAUNCH_ARGS);
template int launch<BohmGross, double>(GFT_WINDOW_LAUNCH_ARGS);

}  // namespace gft
