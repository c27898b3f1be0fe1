// K3's double instantiation; kernels in efit_window_bwd.cuh.

#include "efit_window_bwd.cuh"

namespace gft {

template int launch_bwd<double, true>(const BwdArgs&);

}  // namespace gft
