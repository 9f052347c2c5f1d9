// Fused pseudo-label pass over channel-major logits: the library of
// single-dtype ensembles (all f32 or all bf16).  The kernel, its design
// and the C interface are in pseudo_cm.cuh; mixed ensembles go to
// pseudo_cm_mixed.cu.
#include "pseudo_cm.cuh"

extern "C" int pseudo_cm_launch(PSEUDO_CM_PARAMS) {
  PseudoArgs a;
  const int err = pack_args(a, PSEUDO_CM_ARGS);
  if (err) return err;
  const int all = (1 << n_models) - 1;
  if (a.bf16 != 0 && a.bf16 != all) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hw > 0 && b > 0) {
    if (a.bf16 == 0) launch_dt<DT_F32>(a, b, t1_inst, vec, st);
    else launch_dt<DT_BF16>(a, b, t1_inst, vec, st);
  }
  return (int)cudaGetLastError();
}
