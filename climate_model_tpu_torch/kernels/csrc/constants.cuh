// Physical constants of the kernels, fp32, rounded once from the double
// values of climate_model_tpu_torch/core/constants.py (which the plain
// PyTorch versions combine with fp32 tensors, so both round alike).
// Products and quotients of constants are taken in double first, as Python
// does before it meets a tensor.
#pragma once

namespace cm {

constexpr double kRdD = 287.0;
constexpr double kRvD = 461.5;
constexpr double kCpD = 1004.0;
constexpr double kLvD = 2.501e6;

constexpr float kG = 9.81f;
constexpr float kREarth = 6371000.0f;
constexpr float kRd = (float)kRdD;
constexpr float kCp = (float)kCpD;
constexpr float kKappa = (float)(kRdD / kCpD);
constexpr float kOnePlusKappa = (float)(1.0 + kRdD / kCpD);
constexpr float kPRef = 100000.0f;
constexpr float kLv = (float)kLvD;
constexpr float kLv2 = (float)(kLvD * kLvD);       // L_V ** 2
constexpr float kLvOverCp = (float)(kLvD / kCpD);  // L_V / C_P
constexpr float kCpRv = (float)(kCpD * kRvD);      // C_P * R_V
constexpr float kEps = (float)(kRdD / kRvD);       // EPS_V
constexpr float kOneMinusEps = (float)(1.0 - kRdD / kRvD);
constexpr float kMagnusE0 = 610.94f;
constexpr float kMagnusA = 17.625f;
constexpr float kMagnusB = 243.04f;
constexpr float kTZeroC = 273.15f;
constexpr float kRhoWater = 1000.0f;

// Correctly rounded reciprocals of constant divisors (for div_rn of
// column.cuh), rounded once from the double quotient of the float value.
constexpr float kRecipG = (float)(1.0 / (double)kG);
constexpr float kRecipPRef = (float)(1.0 / (double)kPRef);

}  // namespace cm
