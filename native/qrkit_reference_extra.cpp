// Baseline measurement tool #3: the reference QRKit's BandedBlockedSparseQR
// and BlockAngularSparseQR factorize+solve wall times on the same problem
// shapes this repo benches on the accelerator:
//
//   banded       — the BASELINE config-3 shape (examples/bench_banded.py
//                  config3): nb blocks of br x bc overlapping ov columns
//                  (default 2499 x [40x8] ov 4 = 99,960 x 10,000, bandwidth 8)
//   blockangular — the ellipse-fitting Jacobian shape
//                  (bench/bench_sparse_qr_extra.cpp:153-175): [J1 | J2] with
//                  J1 = 2N x N block-diagonal of 2x1 blocks, J2 = 2N x 5 dense;
//                  solver stack = BlockDiagonalSparseQR left (ColPiv 2x1
//                  blocks) + dense ColPivHouseholderQR right, the reference
//                  bench's own "SparseBlockDiagonalQR" stack in the current
//                  header API (the bench file's typedefs are API-stale).
//
// This measures the REFERENCE implementation itself (headers included from
// /root/reference, unmodified).  Modern Eigen removed DynamicSparseMatrix;
// the reference uses it only inside sparse-Q-materialization template members
// this tool never instantiates, so a forward declaration satisfies name
// lookup at parse time (recorded workaround, BandedBlockedSparseQR.h:553).
//
// Build: make -C native qrkit_reference_extra
// Run:   ./qrkit_reference_extra banded [nb] [reps]
//        ./qrkit_reference_extra blockangular [N] [reps]
#include <cassert>
#include <iostream>
#include <thread>

#include <Eigen/Core>
#include <Eigen/QR>
#include <Eigen/Sparse>

namespace Eigen {
// Removed from modern Eigen; referenced (never instantiated here) by
// BandedBlockedSparseQR.h:553 / BlockedThinQRBase.h:367.
template <typename Scalar, int Options, typename Index>
class DynamicSparseMatrix;
}  // namespace Eigen

#include "QRKit/SparseQRUtils.h"
#include "QRKit/SparseQROrdering.h"
#include "QRKit/BlockYTY.h"
#include "QRKit/SparseBlockCOO.h"
#include "QRKit/SparseBlockDiagonal.h"
#include "QRKit/BlockMatrix1x2.h"
#include "QRKit/SparseBlockYTY.h"
#include "QRKit/BlockDiagonalSparseQR.h"
#include "QRKit/BandedBlockedSparseQR.h"
#include "QRKit/BlockAngularSparseQR.h"

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>

using namespace Eigen;

typedef SparseMatrix<double, ColMajor, int> JacobianType;

// The reference's block solvers must export MatrixQType/MatrixRType
// (the same shim its own tests use, test-qrkit.cpp:33-38).
template <typename MatrixType>
struct ColPivQRShim : public ColPivHouseholderQR<MatrixType> {
  typedef Matrix<double, MatrixType::RowsAtCompileTime,
                 MatrixType::RowsAtCompileTime>
      MatrixQType;
  typedef MatrixType MatrixRType;
};

static double now_minus(const std::chrono::steady_clock::time_point& t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

// ---- banded: config-3 shape (examples/bench_banded.py banded_matrix) -------
// Same generator: block i occupies rows [i*br, (i+1)*br), cols
// [i*(bc-ov), i*(bc-ov)+bc) clipped to ncols, values uniform(0.5, 5).
static int run_banded(int nb, int reps) {
  const int br = 40, bc = 8, ov = 4, step = bc - ov;
  // test-qrkit.cpp:41 uses a dynamic HouseholderQR block solver; overlap and
  // suggested block cols are the template knobs (here matching the shape).
  typedef HouseholderQR<Matrix<double, Dynamic, Dynamic>> BandBlockQRSolver;
  typedef QRKit::BandedBlockedSparseQR<JacobianType, BandBlockQRSolver, 4, 8>
      Solver;

  const int m = nb * br, n = step * nb + ov;
  std::mt19937 gen(42);
  std::uniform_real_distribution<double> dist(0.5, 5.0);

  std::vector<Triplet<double>> trip;
  trip.reserve(size_t(nb) * br * bc);
  for (int i = 0; i < nb; i++)
    for (int r = 0; r < br; r++)
      for (int c = 0; c < bc; c++) {
        int col = i * step + c;
        if (col < n) trip.emplace_back(i * br + r, col, dist(gen));
      }
  JacobianType J(m, n);
  J.setFromTriplets(trip.begin(), trip.end());
  J.makeCompressed();

  VectorXd xt = VectorXd::Random(n);
  VectorXd b = J * xt;

  double best_fac = 1e300, best_sol = 1e300;
  VectorXd x;
  for (int rep = 0; rep < reps; rep++) {
    Solver qr;
    auto t0 = std::chrono::steady_clock::now();
    qr.compute(J);
    double fac = now_minus(t0);
    VectorXd bp = qr.rowsPermutation() * b;
    t0 = std::chrono::steady_clock::now();
    VectorXd y = qr.matrixQ().transpose() * bp;
    VectorXd z = qr.matrixR()
                     .topLeftCorner(n, n)
                     .template triangularView<Upper>()
                     .solve(y.topRows(n));
    x = VectorXd::Zero(n);
    for (int i = 0; i < n; i++) x(qr.colsPermutation().indices()(i)) = z(i);
    double sol = now_minus(t0);
    if (fac < best_fac) best_fac = fac;
    if (sol < best_sol) best_sol = sol;
  }
  double rel = (J * x - b).norm() / b.norm();
  printf(
      "{\"tool\": \"reference_qrkit_banded\", \"nb\": %d, \"br\": %d, "
      "\"bc\": %d, \"overlap\": %d, \"rows\": %d, \"cols\": %d, "
      "\"factorize_seconds\": %.6f, \"solve_seconds\": %.6f, "
      "\"rel_resid\": %.3e}\n",
      nb, br, bc, ov, m, n, best_fac, best_sol, rel);
  return rel < 1e-10 ? 0 : 1;
}

// ---- blockangular: ellipse Jacobian shape ----------------------------------
static int run_blockangular(int N, int reps) {
  typedef Matrix<double, 2, 1> Blk;
  typedef ColPivQRShim<Blk> DenseQRSolver2x1;
  typedef QRKit::BlockDiagonalSparseQR<DenseQRSolver2x1> LeftSolver;
  typedef ColPivQRShim<Matrix<double, Dynamic, Dynamic>> RightSolver;
  typedef QRKit::BlockAngularSparseQR<LeftSolver, RightSolver> Solver;

  const int m = 2 * N, n1 = N, n2 = 5, n = n1 + n2;
  std::mt19937 gen(42);
  std::uniform_real_distribution<double> dist(0.5, 5.0);

  JacobianType J1(m, n1);
  J1.reserve(VectorXi::Constant(n1, 2));
  for (int i = 0; i < N; i++) {
    J1.insert(2 * i, i) = dist(gen);
    J1.insert(2 * i + 1, i) = dist(gen);
  }
  J1.makeCompressed();
  MatrixXd J2(m, n2);
  for (int r = 0; r < m; r++)
    for (int c = 0; c < n2; c++) J2(r, c) = dist(gen);

  VectorXd xt = VectorXd::Random(n);
  VectorXd b = J1 * xt.head(n1) + J2 * xt.tail(n2);

  QRKit::SparseBlockDiagonal<Blk> blkDiag;
  blkDiag.fromBlockDiagonalPattern(J1, 2, 1);
  QRKit::BlockMatrix1x2<QRKit::SparseBlockDiagonal<Blk>, MatrixXd> blkAngular(
      blkDiag, J2);

  double best_fac = 1e300, best_sol = 1e300;
  VectorXd x;
  for (int rep = 0; rep < reps; rep++) {
    Solver qr;
    auto t0 = std::chrono::steady_clock::now();
    qr.compute(blkAngular);
    double fac = now_minus(t0);
    VectorXd bp = qr.rowsPermutation() * b;
    t0 = std::chrono::steady_clock::now();
    VectorXd y = qr.matrixQ().transpose() * bp;
    VectorXd z = qr.matrixR()
                     .topLeftCorner(n, n)
                     .template triangularView<Upper>()
                     .solve(y.topRows(n));
    x = VectorXd::Zero(n);
    for (int i = 0; i < n; i++) x(qr.colsPermutation().indices()(i)) = z(i);
    double sol = now_minus(t0);
    if (fac < best_fac) best_fac = fac;
    if (sol < best_sol) best_sol = sol;
  }
  VectorXd r = J1 * x.head(n1) + J2 * x.tail(n2) - b;
  double rel = r.norm() / b.norm();
  printf(
      "{\"tool\": \"reference_qrkit_blockangular\", \"N\": %d, \"rows\": %d, "
      "\"cols\": %d, \"factorize_seconds\": %.6f, \"solve_seconds\": %.6f, "
      "\"rel_resid\": %.3e}\n",
      N, m, n, best_fac, best_sol, rel);
  return rel < 1e-10 ? 0 : 1;
}

int main(int argc, char** argv) {
  const char* mode = argc > 1 ? argv[1] : "banded";
  int size = argc > 2 ? atoi(argv[2]) : 0;
  int reps = argc > 3 ? atoi(argv[3]) : 3;
  if (!strcmp(mode, "banded")) return run_banded(size ? size : 2499, reps);
  if (!strcmp(mode, "blockangular"))
    return run_blockangular(size ? size : 500, reps);
  fprintf(stderr, "usage: %s banded|blockangular [size] [reps]\n", argv[0]);
  return 2;
}
