// K1's instantiations for models/dispersion.py ion_cyclotron; the kernel template
// is in efit_window.cuh, the C interface in efit_window.cu.

#include "efit_window.cuh"

namespace gft {

template int launch<IonCyclotron, float>(GFT_WINDOW_LAUNCH_ARGS);
template int launch<IonCyclotron, double>(GFT_WINDOW_LAUNCH_ARGS);

}  // namespace gft
