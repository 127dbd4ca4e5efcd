/* Host-native kernel-density evaluator — the C replacement of gryffin's
 * compiled Cython extension (kernel_evaluations.pyx, built by its setup.py)
 * and the OpenMP prob reshaper (kernel_prob_reshaping.pyx).
 *
 * A copy of the JAX package's search/native/kernel_evaluator.c. In the
 * PyTorch port it is the float64 oracle of search/kernels.py.
 *
 * Exposes a flat-C ABI consumed via ctypes (search/native/__init__.py):
 *   kernel_contrib_categorical: for S candidate samples over categorical
 *     dims, compute num[s] and inv_den[s] of the acquisition from posterior
 *     categorical kernel probs (draws x obs x total_options), averaging the
 *     per-draw product kernels — the exact math of
 *     kernel_evaluations.pyx:146-193, OpenMP-parallel over candidates.
 *   reshape_cat_probs: descriptor-space distances -> softmax probs,
 *     the math of kernel_prob_reshaping.pyx:41-70.
 *
 * Build: cc -O3 -shared -fPIC kernel_evaluator.c -o libkernel_evaluator.so -lm
 * (search/native/__init__.py builds it serial at first use; -fopenmp
 * parallelises it over candidates where the compiler has OpenMP).
 */
#include <math.h>
#include <stddef.h>

#ifdef _OPENMP
#include <omp.h>
#endif

void kernel_contrib_categorical(
    const double *cat_probs, /* (draws, obs, total_options) */
    const long *offsets,     /* (dims,) option-block starts */
    const long *samples,     /* (S, dims) option indices */
    const double *objs,      /* (obs,) */
    double inv_vol,
    long draws, long obs, long total_options, long dims, long S,
    double *num_out,     /* (S,) */
    double *inv_den_out, /* (S,) */
    double *probs_out    /* (S, obs) or NULL */
) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long s = 0; s < S; ++s) {
        const long *x = samples + s * dims;
        double num = 0.0, den = 0.0;
        for (long o = 0; o < obs; ++o) {
            double acc = 0.0;
            for (long d = 0; d < draws; ++d) {
                const double *p = cat_probs + (d * obs + o) * total_options;
                double prod = 1.0;
                for (long k = 0; k < dims; ++k) {
                    prod *= p[offsets[k] + x[k]];
                }
                acc += prod;
            }
            double prob = acc / (double)draws;
            if (probs_out) probs_out[s * obs + o] = prob;
            num += objs[o] * prob;
            den += prob;
        }
        num_out[s] = num;
        inv_den_out[s] = 1.0 / (inv_vol + den);
    }
}

/* descriptor-distance softmax (kernel_prob_reshaping.pyx:41-70):
 * for each (draw, obs, dim-block): probs over options o proportional to
 * exp(-||desc[o] - sum_o' raw_prob[o'] desc[o']||^2 / sigma). */
void reshape_cat_probs(
    const double *raw_probs,   /* (draws, obs, options) one dim block */
    const double *descriptors, /* (options, desc_dim) */
    long draws, long obs, long options, long desc_dim,
    double sigma,
    double *out /* (draws, obs, options) */
) {
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
    for (long d = 0; d < draws; ++d) {
        for (long o = 0; o < obs; ++o) {
            const double *rp = raw_probs + (d * obs + o) * options;
            double *op = out + (d * obs + o) * options;
            /* expected descriptor under raw probs */
            double mean[64];
            for (long j = 0; j < desc_dim && j < 64; ++j) {
                double m = 0.0;
                for (long k = 0; k < options; ++k)
                    m += rp[k] * descriptors[k * desc_dim + j];
                mean[j] = m;
            }
            double maxv = -1e300;
            for (long k = 0; k < options; ++k) {
                double dist = 0.0;
                for (long j = 0; j < desc_dim && j < 64; ++j) {
                    /* kernel_prob_reshaping.pyx:55-60: dyi = K*(desc - avg),
                       dist = sqrt(mean(dyi^2)) */
                    double diff =
                        (double)options *
                        (descriptors[k * desc_dim + j] - mean[j]);
                    dist += diff * diff;
                }
                dist = sqrt(dist / (double)(desc_dim < 64 ? desc_dim : 64));
                op[k] = -dist / sigma;
                if (op[k] > maxv) maxv = op[k];
            }
            double z = 0.0;
            for (long k = 0; k < options; ++k) {
                op[k] = exp(op[k] - maxv);
                z += op[k];
            }
            for (long k = 0; k < options; ++k) op[k] /= z;
        }
    }
}
