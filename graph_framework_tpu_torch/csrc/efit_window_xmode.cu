// K1's instantiations for the X mode (models/dispersion.py extra_ordinary_wave); the kernel
// template is in efit_window.cuh, the C interface in efit_window.cu.

#include "efit_window.cuh"

namespace gft {

template int launch<ExtraOrdinaryWave, float>(GFT_WINDOW_LAUNCH_ARGS);
template int launch<ExtraOrdinaryWave, double>(GFT_WINDOW_LAUNCH_ARGS);

}  // namespace gft
