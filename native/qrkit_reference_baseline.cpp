// Baseline measurement tool #2: the reference QRKit's own
// BlockDiagonalSparseQR (ColPivHouseholderQR per block) factorize+solve wall
// time on the same block-diagonal least-squares problem bench.py times on the
// accelerator (nb dense blocks of br x bc, uniform(0.5, 5) values, double precision).
//
// This measures the REFERENCE implementation itself (headers included from
// /root/reference, unmodified) so bench.py's vs_baseline comparisons can cite
// a same-machine QRKit number rather than only generic Eigen SparseQR.
//
// Build: g++ -O3 -DNDEBUG -std=c++17 -I <eigen include> -I /root/reference/src \
//            qrkit_reference_baseline.cpp -o qrkit_reference_baseline
//   (we include BlockDiagonalSparseQR.h directly, not the QRKit umbrella
//    header, because BandedBlockedSparseQR.h uses Eigen::DynamicSparseMatrix,
//    removed from current Eigen; also pre-include <iostream>/<thread> that
//    older Eigen pulled in transitively)
// Run:   ./qrkit_reference_baseline <nb> <br> <bc> [reps]
#include <cassert>
#include <iostream>
#include <thread>

#include <Eigen/Core>
#include <Eigen/QR>
#include <Eigen/Sparse>

#include "QRKit/BlockDiagonalSparseQR.h"

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <random>

using namespace Eigen;

// The reference's block solvers must export MatrixQType/MatrixRType
// (the same 4-line shim its own tests use, test-qrkit.cpp:33-38).
template <typename MatrixType>
struct ColPivQRShim : public ColPivHouseholderQR<MatrixType> {
  typedef Matrix<double, MatrixType::RowsAtCompileTime,
                 MatrixType::RowsAtCompileTime>
      MatrixQType;
  typedef MatrixType MatrixRType;
};

int main(int argc, char** argv) {
  int nb = argc > 1 ? atoi(argv[1]) : 10000;
  int br = argc > 2 ? atoi(argv[2]) : 7;
  int bc = argc > 3 ? atoi(argv[3]) : 2;
  int reps = argc > 4 ? atoi(argv[4]) : 5;
  if (br != 7 || bc != 2) {
    fprintf(stderr, "block shape fixed at 7x2 (compile-time in the wrapper)\n");
    return 2;
  }

  typedef Matrix<double, 7, 2> Blk;
  typedef ColPivQRShim<Blk> BlockSolver;
  typedef QRKit::BlockDiagonalSparseQR<BlockSolver> Solver;

  const int m = nb * br, n = nb * bc;
  std::mt19937 gen(42);
  std::uniform_real_distribution<double> dist(0.5, 5.0);

  SparseMatrix<double, RowMajor, int> J(m, n);
  J.reserve(VectorXi::Constant(m, bc));
  for (int i = 0; i < nb; i++)
    for (int r = 0; r < br; r++)
      for (int c = 0; c < bc; c++) J.insert(i * br + r, i * bc + c) = dist(gen);
  J.makeCompressed();

  VectorXd xt = VectorXd::Random(n);
  VectorXd b = VectorXd::Zero(m);
  // b = J * xt via the dense blocks (J is row-major; direct product is fine)
  b = J * xt;

  QRKit::SparseBlockDiagonal<Blk> blkDiag;
  blkDiag.fromBlockDiagonalPattern(J, br, bc);

  double best = 1e300;
  VectorXd x;
  for (int rep = 0; rep < reps; rep++) {
    auto t0 = std::chrono::steady_clock::now();
    Solver qr;
    qr.compute(blkDiag);
    VectorXd y = qr.matrixQ().transpose() * b;
    VectorXd z = qr.matrixR()
                     .topLeftCorner(n, n)
                     .template triangularView<Upper>()
                     .solve(y.topRows(n));
    x = qr.colsPermutation() * z;
    auto t1 = std::chrono::steady_clock::now();
    double s = std::chrono::duration<double>(t1 - t0).count();
    if (s < best) best = s;
  }
  double rel = (J * x - b).norm() / b.norm();
  printf(
      "{\"tool\": \"reference_qrkit_blockdiagonal\", \"nb\": %d, \"br\": %d, "
      "\"bc\": %d, \"seconds\": %.6f, \"rel_resid\": %.3e}\n",
      nb, br, bc, best, rel);
  return rel < 1e-10 ? 0 : 1;
}
