// Baseline measurement tool: Eigen SparseQR factorize+solve wall time on a
// block-diagonal least-squares problem (the BASELINE.json config-2 shape:
// nb dense blocks of br x bc on the diagonal).  Used once to produce
// bench_baseline.json; mirrors what bench.py times on the accelerator.
//
// Build: g++ -O3 -DNDEBUG -I <eigen include> eigen_baseline.cpp -o eigen_baseline
// Run:   ./eigen_baseline <nb> <br> <bc> [reps]
#include <Eigen/Sparse>
#include <Eigen/SparseQR>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

int main(int argc, char** argv) {
  int nb = argc > 1 ? atoi(argv[1]) : 10000;
  int br = argc > 2 ? atoi(argv[2]) : 7;
  int bc = argc > 3 ? atoi(argv[3]) : 2;
  int reps = argc > 4 ? atoi(argv[4]) : 1;

  int m = nb * br, n = nb * bc;
  std::mt19937 gen(42);
  std::uniform_real_distribution<double> dist(0.5, 5.0);

  typedef Eigen::SparseMatrix<double, Eigen::ColMajor, int> SpMat;
  std::vector<Eigen::Triplet<double>> trips;
  trips.reserve((size_t)nb * br * bc);
  for (int i = 0; i < nb; i++)
    for (int c = 0; c < bc; c++)
      for (int r = 0; r < br; r++)
        trips.emplace_back(i * br + r, i * bc + c, dist(gen));
  SpMat A(m, n);
  A.setFromTriplets(trips.begin(), trips.end());
  A.makeCompressed();

  Eigen::VectorXd x_true = Eigen::VectorXd::Random(n);
  Eigen::VectorXd b = A * x_true;

  double best = 1e30;
  double err = 0;
  for (int rep = 0; rep < reps; rep++) {
    auto t0 = std::chrono::steady_clock::now();
    Eigen::SparseQR<SpMat, Eigen::COLAMDOrdering<int>> qr(A);
    Eigen::VectorXd x = qr.solve(b);
    auto t1 = std::chrono::steady_clock::now();
    double s = std::chrono::duration<double>(t1 - t0).count();
    if (s < best) best = s;
    err = (x - x_true).norm() / x_true.norm();
  }
  printf("{\"nb\": %d, \"br\": %d, \"bc\": %d, \"seconds\": %.6f, \"rel_err\": %.3e}\n",
         nb, br, bc, best, err);
  return 0;
}
