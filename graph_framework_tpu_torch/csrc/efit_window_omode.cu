// K1's instantiations for the O mode (models/dispersion.py ordinary_wave); the kernel
// template is in efit_window.cuh, the C interface in efit_window.cu.

#include "efit_window.cuh"

namespace gft {

template int launch<OrdinaryWave, float>(GFT_WINDOW_LAUNCH_ARGS);
template int launch<OrdinaryWave, double>(GFT_WINDOW_LAUNCH_ARGS);

}  // namespace gft
