// The O mode's K3's float instantiation; kernels in efit_window_bwd.cuh.

#include "efit_window_bwd.cuh"

namespace gft {

template int launch_bwd<OrdinaryWave, float, true>(const BwdArgs&);

}  // namespace gft
