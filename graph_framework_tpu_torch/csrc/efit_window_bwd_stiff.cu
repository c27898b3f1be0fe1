// K2's instantiations for models/dispersion.py stiff, f32 and f64 (it
// reads no table: no K3); kernels in efit_window_bwd.cuh, the C interface
// in efit_window_bwd.cu.

#include "efit_window_bwd.cuh"

namespace gft {

template int launch_bwd_of<Stiff>(int, bool, const BwdArgs&);

}  // namespace gft
