// Fused pseudo-label pass over channel-major logits: the library of
// mixed ensembles, some models' logits bf16 and others' f32 (a
// self-training round's bf16 sources and f32 target model).  The kernel,
// its design and the C interface are in pseudo_cm.cuh; these instances
// hold both loads and so twice the code of a single-dtype one, and are
// compiled on their own, beside pseudo_cm.cu.  They read any mix, a
// single-dtype one too (tools/torch_pseudo_dtypes.py times them so).
#include "pseudo_cm.cuh"

extern "C" int pseudo_cm_mixed_launch(PSEUDO_CM_PARAMS) {
  PseudoArgs a;
  const int err = pack_args(a, PSEUDO_CM_ARGS);
  if (err) return err;
  if (hw > 0 && b > 0)
    launch_dt<DT_MIXED>(a, b, t1_inst, vec,
                        reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
