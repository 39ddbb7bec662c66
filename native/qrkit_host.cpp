// qrkit_host — native host-side structure engine (C ABI, loaded via ctypes).
//
// Accelerator-side counterpart of the reference's header-only C++ analysis tier
// (/root/reference/src/QRKit/SparseQRUtils.h:179-386, SparseQROrdering.h):
// the pointer-chasing pattern analysis, orderings and dense-panel extraction
// run on the host CPU and feed static plans / padded panels to the XLA device
// code.  The NumPy implementations in qrkit_tpu/analysis.py are the reference
// semantics; this library is the production path for large matrices (panel
// extraction especially is the hot host-side op in the banded solver's
// compute()).  Kept in exact behavioral parity — tests compare both.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Per-row band [start, end] column indices; empty rows get start = end = ncols.
// (BlockBandedMatrixInfo::operator() step 1, SparseQRUtils.h:193-221)
void qrkit_row_ranges(int64_t nrows, int64_t ncols, const int64_t* indptr,
                      const int64_t* indices, int64_t* starts, int64_t* ends) {
  for (int64_t i = 0; i < nrows; i++) {
    int64_t lo = indptr[i], hi = indptr[i + 1];
    if (hi > lo) {
      starts[i] = indices[lo];
      ends[i] = indices[hi - 1];
    } else {
      starts[i] = ncols;
      ends[i] = ncols;
    }
  }
}

// As-banded-as-possible row ordering: stable sort rows by band start.
// Writes Eigen-style indices (indices[orig] = new); returns 1 if a
// non-identity permutation was needed.  (SparseQROrdering.h:52-120)
int qrkit_abap_order(int64_t nrows, const int64_t* starts, int64_t* out_indices) {
  std::vector<int64_t> order(nrows);
  std::iota(order.begin(), order.end(), 0);
  bool sorted = true;
  for (int64_t i = 1; i < nrows; i++)
    if (starts[i] < starts[i - 1]) { sorted = false; break; }
  if (!sorted) {
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return starts[a] < starts[b];
    });
  }
  for (int64_t newIdx = 0; newIdx < nrows; newIdx++)
    out_indices[order[newIdx]] = newIdx;
  return sorted ? 0 : 1;
}

// Column nnz counts (ColumnDensity input, SparseQROrdering.h:22-50).
void qrkit_col_nnz(int64_t nnz, const int64_t* indices, int64_t ncols,
                   int64_t* counts) {
  std::memset(counts, 0, sizeof(int64_t) * ncols);
  for (int64_t k = 0; k < nnz; k++) counts[indices[k]]++;
}

// Block-banded structure detection + merge.  starts/ends are the (already
// row-sorted) per-row bands.  Emits up to max_blocks blocks as
// (row, col, nrows, ncols) quadruples; returns the block count (or -1 on
// overflow).  Mirrors BlockBandedMatrixInfo::operator() + mergeBlocks
// (SparseQRUtils.h:186-385) including the fold-remainder-into-last rule.
int64_t qrkit_block_detect(int64_t nrows, int64_t ncols, const int64_t* starts,
                           const int64_t* ends, int64_t suggested_cols,
                           int64_t* out_blocks, int64_t max_blocks,
                           int64_t* nnz_q_estimate) {
  struct Blk { int64_t row, col, nr, nc; };
  std::vector<Blk> cand;
  cand.reserve(1024);
  int64_t max_col_step = 0;
  for (int64_t i = 1; i < nrows; i++)
    max_col_step = std::max(max_col_step, starts[i] - starts[i - 1]);

  int64_t nnz_q = 0;
  for (int64_t i = 0; i < nrows;) {
    int64_t s = starts[i];
    if (s >= ncols) { i++; continue; }  // zero row
    int64_t first_row = i, height = 0, width = 0;
    while (i < nrows && starts[i] == s) {
      width = std::max(width, ends[i] - s + 1);
      height++; i++;
    }
    cand.push_back({first_row, s, height, width});
    nnz_q += height * height;
  }
  *nnz_q_estimate = nnz_q;

  // mergeBlocks
  std::vector<Blk> merged;
  bool have_first = false;
  Blk first{0, 0, 0, 0};
  int64_t curr_rows = 0, curr_cols = 0;
  for (const Blk& curr : cand) {
    if (!merged.empty()) {
      Blk& last = merged.back();
      if (curr.col + curr.nc <= last.col + last.nc) {
        last.nr += curr.nr;
        continue;
      }
    }
    if (!have_first) {
      first = curr; have_first = true;
      curr_rows = curr.nr; curr_cols = curr.nc;
    } else {
      curr_rows = curr.row + curr.nr - first.row;
      curr_cols = curr.col + curr.nc - first.col;
    }
    if (curr_rows > curr_cols && curr_cols >= max_col_step &&
        curr_cols >= suggested_cols) {
      merged.push_back({first.row, first.col, curr_rows, curr_cols});
      have_first = false;
    }
  }
  if (have_first) {
    if (curr_rows > curr_cols && curr_cols >= max_col_step &&
        curr_cols >= suggested_cols) {
      merged.push_back({first.row, first.col, curr_rows, curr_cols});
    } else if (!merged.empty()) {
      Blk& last = merged.back();
      last.nr += curr_rows;
      last.nc = first.col + curr_cols - last.col;
    }
  }

  if ((int64_t)merged.size() > max_blocks) return -1;
  for (size_t k = 0; k < merged.size(); k++) {
    out_blocks[4 * k + 0] = merged[k].row;
    out_blocks[4 * k + 1] = merged[k].col;
    out_blocks[4 * k + 2] = merged[k].nr;
    out_blocks[4 * k + 3] = merged[k].nc;
  }
  return (int64_t)merged.size();
}

// Extract nb dense panels [pad_rows, pad_cols] (row-major, zero-padded) from a
// CSR matrix — the banded solver's device-feed step.  blocks is nb quadruples
// (row, col, nrows, ncols).
void qrkit_extract_panels(int64_t nrows, int64_t ncols, const int64_t* indptr,
                          const int64_t* indices, const double* data,
                          const int64_t* blocks, int64_t nb, int64_t pad_rows,
                          int64_t pad_cols, double* out) {
  std::memset(out, 0, sizeof(double) * nb * pad_rows * pad_cols);
  for (int64_t k = 0; k < nb; k++) {
    int64_t r0 = blocks[4 * k], c0 = blocks[4 * k + 1];
    int64_t nr = blocks[4 * k + 2], nc = blocks[4 * k + 3];
    double* panel = out + k * pad_rows * pad_cols;
    for (int64_t r = 0; r < nr && r0 + r < nrows; r++) {
      int64_t lo = indptr[r0 + r], hi = indptr[r0 + r + 1];
      // binary search to the block's column window
      const int64_t* cb = std::lower_bound(indices + lo, indices + hi, c0);
      for (const int64_t* p = cb; p != indices + hi && *p < c0 + nc; p++) {
        panel[r * pad_cols + (*p - c0)] = data[p - indices];
      }
    }
  }
}

// Row permutation of a CSR matrix (P*A, scatter): writes permuted CSR arrays.
// gather[newIdx] = origIdx (i.e. the inverse of Eigen-style indices).
void qrkit_permute_rows_csr(int64_t nrows, const int64_t* indptr,
                            const int64_t* indices, const double* data,
                            const int64_t* gather, int64_t* out_indptr,
                            int64_t* out_indices, double* out_data) {
  out_indptr[0] = 0;
  for (int64_t i = 0; i < nrows; i++) {
    int64_t src = gather[i];
    int64_t cnt = indptr[src + 1] - indptr[src];
    out_indptr[i + 1] = out_indptr[i] + cnt;
    std::memcpy(out_indices + out_indptr[i], indices + indptr[src],
                sizeof(int64_t) * cnt);
    std::memcpy(out_data + out_indptr[i], data + indptr[src],
                sizeof(double) * cnt);
  }
}

}  // extern "C"
