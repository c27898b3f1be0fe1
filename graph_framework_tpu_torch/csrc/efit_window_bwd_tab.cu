// K3's float instantiation (the window backward with the block
// cotangents); kernels in efit_window_bwd.cuh.

#include "efit_window_bwd.cuh"

namespace gft {

template int launch_bwd<float, true>(const BwdArgs&);

}  // namespace gft
