/* Native whitespace-matrix parser for the reference text data format.
 *
 * The reference's data path (SURVEY.md S3 "Data manager") is numpy.loadtxt,
 * which tokenizes in Python and becomes the dominant setup cost at this
 * framework's scales (16k-row training files, 1M-row prediction designs).
 * One pass of strtod over an in-memory buffer, with loadtxt's default
 * semantics ('#' starts a comment, blank lines skipped, any whitespace
 * separates, consistent column count required). A host file parser, not a
 * device kernel; the PyTorch port keeps its own copy of the JAX package's
 * loader so that neither package imports the other.
 *
 * API (ctypes, see native/__init__.py):
 *   fastload(path, &data, &rows, &cols) -> 0 ok / negative errno-style code
 *   fastload_free(data)
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define FL_OK 0
#define FL_EIO -1        /* cannot open/read file */
#define FL_ERAGGED -2    /* inconsistent number of columns */
#define FL_EPARSE -3     /* token that is not a number */
#define FL_ENOMEM -4

static char *read_all(const char *path, long long *len_out) {
    FILE *f = fopen(path, "rb");
    if (!f) return NULL;
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return NULL; }
    long long len = ftell(f);
    if (len < 0) { fclose(f); return NULL; }
    rewind(f);
    char *buf = (char *)malloc((size_t)len + 1);
    if (!buf) { fclose(f); return NULL; }
    if (len > 0 && fread(buf, 1, (size_t)len, f) != (size_t)len) {
        free(buf); fclose(f); return NULL;
    }
    fclose(f);
    buf[len] = '\0';
    *len_out = len;
    return buf;
}

/* Clinger fast path: when the decimal mantissa fits in 53 bits and the
 * power of ten is exactly representable (|e| <= 22), mantissa->double and
 * one multiply/divide are each exact-then-correctly-rounded, so the result
 * is bit-identical to strtod at a fraction of its cost. Anything outside
 * that envelope (nan/inf/hex, >19 digits, big exponents) returns 0 and the
 * caller falls back to strtod. This is the standard fast_float/abseil
 * decimal fast path. */
static const double pow10tab[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22,
};

static int fast_parse(const char **pp, const char *stop, double *out) {
    const char *p = *pp;
    int neg = 0;
    if (p < stop && (*p == '+' || *p == '-')) { neg = (*p == '-'); p++; }
    uint64_t mant = 0;
    int ndig = 0, exp10 = 0, any = 0;
    while (p < stop && *p >= '0' && *p <= '9') {
        any = 1;
        if (mant == 0 && *p == '0') { /* leading zero: not significant */ }
        else if (ndig < 19) { mant = mant * 10 + (uint64_t)(*p - '0'); ndig++; }
        else exp10++;
        p++;
    }
    if (p < stop && *p == '.') {
        p++;
        while (p < stop && *p >= '0' && *p <= '9') {
            any = 1;
            if (mant == 0 && *p == '0') exp10--;  /* 0.000x: shift only */
            else if (ndig < 19) {
                mant = mant * 10 + (uint64_t)(*p - '0');
                ndig++; exp10--;
            } else return 0;  /* truncating fraction digits changes value */
            p++;
        }
    }
    if (!any) return 0;
    if (p < stop && (*p == 'e' || *p == 'E')) {
        const char *q = p + 1;
        int eneg = 0, e = 0;
        if (q < stop && (*q == '+' || *q == '-')) { eneg = (*q == '-'); q++; }
        if (q >= stop || *q < '0' || *q > '9') return 0;
        while (q < stop && *q >= '0' && *q <= '9') {
            if (e < 100000) e = e * 10 + (*q - '0');
            q++;
        }
        exp10 += eneg ? -e : e;
        p = q;
    }
    /* must end the token cleanly (whitespace or line end) */
    if (p < stop && *p != ' ' && *p != '\t' && *p != '\r') return 0;
    if (mant >> 53) return 0;
    double d = (double)mant;
    if (exp10 > 22 || exp10 < -22) return 0;
    if (exp10 > 0) d *= pow10tab[exp10];
    else if (exp10 < 0) d /= pow10tab[-exp10];
    *out = neg ? -d : d;
    *pp = p;
    return 1;
}

long long fastload(const char *path, double **data_out,
                   long long *rows_out, long long *cols_out) {
    long long len = 0;
    char *buf = read_all(path, &len);
    if (!buf) return FL_EIO;

    size_t cap = 4096;
    double *data = (double *)malloc(cap * sizeof(double));
    if (!data) { free(buf); return FL_ENOMEM; }
    size_t count = 0;
    long long rows = 0, cols = -1;

    char *p = buf;
    char *end = buf + len;
    while (p < end) {
        /* one line at a time so the column-count check stays per-row */
        char *eol = memchr(p, '\n', (size_t)(end - p));
        if (!eol) eol = end;
        char *hash = memchr(p, '#', (size_t)(eol - p));
        char *stop = hash ? hash : eol;
        char *nextp = (eol < end) ? eol + 1 : end;
        /* we only move forward, so destructively bound strtod at the
         * comment/newline once per line */
        *stop = '\0';

        long long row_cols = 0;
        while (p < stop) {
            while (p < stop && (*p == ' ' || *p == '\t' || *p == '\r'))
                p++;
            if (p >= stop) break;
            double v;
            const char *cp = p;
            if (fast_parse(&cp, stop, &v)) {
                p = (char *)cp;
            } else {
                char *next = NULL;
                v = strtod(p, &next);
                if (next == p) {
                    free(data); free(buf);
                    return FL_EPARSE;
                }
                p = next;
            }
            if (count == cap) {
                cap *= 2;
                double *nd = (double *)realloc(data, cap * sizeof(double));
                if (!nd) { free(data); free(buf); return FL_ENOMEM; }
                data = nd;
            }
            data[count++] = v;
            row_cols++;
        }
        if (row_cols > 0) {
            if (cols < 0) cols = row_cols;
            else if (row_cols != cols) {
                free(data); free(buf);
                return FL_ERAGGED;
            }
            rows++;
        }
        p = nextp;
    }
    free(buf);
    if (cols < 0) cols = 0;
    *data_out = data;
    *rows_out = rows;
    *cols_out = cols;
    return FL_OK;
}

void fastload_free(double *p) { free(p); }
