/* Minimal drop-in for the subset of <gsl/gsl_rng.h> used by the
 * reference ngsDist binary (alloc/set/uniform/free of the "taus"
 * generator), backed by this repo's independent Tausworthe
 * implementation (ngsdist_jax/native/src/taus.h).  Used only by the
 * test harness to build the reference binary in an image without GSL;
 * it is NOT part of the framework. */
#ifndef NGSDIST_TEST_GSL_RNG_SHIM_H
#define NGSDIST_TEST_GSL_RNG_SHIM_H

#include <stdlib.h>
#include "../../../../ngsdist_jax/native/src/taus.h"

typedef struct {
  const char *name;
} gsl_rng_type;

typedef struct {
  nd_taus_state st;
} gsl_rng;

static const gsl_rng_type gsl_rng_taus_shim_type = {"taus"};
static const gsl_rng_type *const gsl_rng_taus = &gsl_rng_taus_shim_type;

static inline gsl_rng *gsl_rng_alloc(const gsl_rng_type *T) {
  (void)T;
  gsl_rng *r = (gsl_rng *)malloc(sizeof(gsl_rng));
  nd_taus_seed(&r->st, 0);
  return r;
}

static inline void gsl_rng_set(gsl_rng *r, unsigned long int seed) {
  nd_taus_seed(&r->st, (uint32_t)seed);
}

static inline double gsl_rng_uniform(gsl_rng *r) {
  return nd_taus_uniform(&r->st);
}

static inline void gsl_rng_free(gsl_rng *r) { free(r); }

#endif
