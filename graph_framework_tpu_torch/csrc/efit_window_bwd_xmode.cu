// The X mode's K2's float instantiation; kernels in efit_window_bwd.cuh.

#include "efit_window_bwd.cuh"

namespace gft {

template int launch_bwd<ExtraOrdinaryWave, float, false>(const BwdArgs&);

}  // namespace gft
