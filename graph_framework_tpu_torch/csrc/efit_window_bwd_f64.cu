// K2's double instantiation; kernels in efit_window_bwd.cuh.

#include "efit_window_bwd.cuh"

namespace gft {

template int launch_bwd<double, false>(const BwdArgs&);

}  // namespace gft
