// K2's and K3's instantiations for models/dispersion.py extra_ordinary_wave, f32 and
// f64; kernels in efit_window_bwd.cuh, the C interface in efit_window_bwd.cu.

#include "efit_window_bwd.cuh"

namespace gft {

template int launch_bwd_of<ExtraOrdinaryWave>(int, bool, const BwdArgs&);

}  // namespace gft
