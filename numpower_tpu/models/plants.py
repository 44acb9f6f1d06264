"""Benchmark plants (dynamics models).

These are the BASELINE.json measurement configs' plants:
  #1 double-integrator LQR       (2-state, 1-input)
  #2/#5 LTI MPC / tube-MPC       (any LTI instance)
  #3 cartpole iLQR               (4-state nonlinear, 1-input)
  #4 quadrotor trajopt           (12-state linearized hover, 4-input)

The reference has no plant library — users hand-roll dynamics in PHP loops
over nd::matmul/add (SURVEY.md §5 "long-context" note). Here plants are
first-class: an LTI plant is an (A, B) pair; nonlinear plants are pure jax
functions `f(x, u) -> x_next` usable under jit/vmap/scan and differentiable
with jax.jacfwd (the idiomatic upgrade over finite differences).

All matrices are fp32 row-major, discrete-time (dt pre-applied), sized so
batched stacks are plain dense tensors for XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LTIPlant(NamedTuple):
    """Discrete-time x_{t+1} = A x_t + B u_t.

    A/B are HOST numpy arrays by construction: when closure-captured by a
    jitted solver they lower as embedded HLO constants with no device->host
    fetch; when passed as jit arguments they transfer once like any
    input."""

    A: jax.Array  # (n, n) — numpy on construction, accepted anywhere jax is
    B: jax.Array  # (n, m)

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.B.shape[-1]

    def step(self, x, u):
        return self.A @ x + self.B @ u


def double_integrator(dt: float = 0.1) -> LTIPlant:
    """BASELINE config #1: 1-D double integrator (pos, vel) with force input.

    Matrices are assembled in host numpy so they lower as embedded HLO
    constants — eager device scatter chains would both dispatch per-element
    and force device->host fetches at trace time."""
    import numpy as np

    A = np.array([[1.0, dt], [0.0, 1.0]], np.float32)
    B = np.array([[0.5 * dt * dt], [dt]], np.float32)
    return LTIPlant(A, B)


def quadrotor12(dt: float = 0.02) -> LTIPlant:
    """BASELINE config #4: 12-state quadrotor linearized about hover.

    State: [pos(3), vel(3), rpy(3), angular rate(3)];
    inputs: [total thrust delta, body torques(3)] (mass/inertia normalized).
    Standard hover linearization: horizontal accelerations couple to roll/
    pitch via gravity tilt; yaw decoupled; altitude couples to thrust.
    """
    import numpy as np

    g = 9.81
    n, m = 12, 4
    A = np.eye(n, dtype=np.float32)
    # pos += vel*dt
    A[0, 3] = A[1, 4] = A[2, 5] = dt
    # horizontal vel += g*tilt*dt  (x couples to pitch(7), y to -roll(6))
    A[3, 7] = g * dt
    A[4, 6] = -g * dt
    # attitude += rate*dt
    A[6, 9] = A[7, 10] = A[8, 11] = dt
    B = np.zeros((n, m), np.float32)
    # thrust -> vertical acceleration; torques -> angular accelerations
    B[5, 0] = dt
    B[9, 1] = B[10, 2] = B[11, 3] = dt
    return LTIPlant(A, B)


def cartpole_params():
    return dict(mc=1.0, mp=0.1, l=0.5, g=9.81, dt=0.05)


def cartpole_step(x, u, mc=1.0, mp=0.1, l=0.5, g=9.81, dt=0.05):
    """BASELINE config #3: nonlinear cartpole, semi-implicit Euler.

    State [pos, theta, vel, theta_dot]; input: cart force (1,).
    Pure jax function — jit/vmap/scan/jacfwd-compatible (compare the
    reference approach: PHP loops over eager nd ops, SURVEY.md §3.2).
    """
    pos, th, v, w = x[0], x[1], x[2], x[3]
    f = u[0]
    sin_t, cos_t = jnp.sin(th), jnp.cos(th)
    total_m = mc + mp
    tmp = (f + mp * l * w * w * sin_t) / total_m
    th_acc = (g * sin_t - cos_t * tmp) / (l * (4.0 / 3.0 - mp * cos_t * cos_t / total_m))
    x_acc = tmp - mp * l * th_acc * cos_t / total_m
    v2 = v + x_acc * dt
    w2 = w + th_acc * dt
    return jnp.stack([pos + v2 * dt, th + w2 * dt, v2, w2])


def pendulum_step(x, u, g=9.81, l=1.0, m=1.0, dt=0.05):
    """Simple pendulum swing-up plant (extra nonlinear test case).
    State [theta, theta_dot]; input torque (1,)."""
    th, w = x[0], x[1]
    w2 = w + (-(g / l) * jnp.sin(th) + u[0] / (m * l * l)) * dt
    return jnp.stack([th + w2 * dt, w2])


def unicycle_step(x, u, dt=0.1):
    """Unicycle / differential-drive kinematics (nonholonomic — exercises
    solvers on a plant where linearization loses controllability at rest).
    State [px, py, heading]; input [forward speed, turn rate]."""
    px, py, th = x[0], x[1], x[2]
    v, w = u[0], u[1]
    return jnp.stack([
        px + v * jnp.cos(th) * dt,
        py + v * jnp.sin(th) * dt,
        th + w * dt,
    ])


def planar_quadrotor_step(x, u, m=1.0, l=0.3, inertia=0.1, g=9.81, dt=0.05):
    """Planar quadrotor (2-D VTOL): 6-state, 2 thrust inputs. The classic
    underactuated benchmark between cartpole (4) and quadrotor12.
    State [px, pz, phi, vx, vz, phi_dot]; input [f1, f2] rotor thrusts."""
    px, pz, phi, vx, vz, w = x[0], x[1], x[2], x[3], x[4], x[5]
    f1, f2 = u[0], u[1]
    ft = f1 + f2
    ax = -ft * jnp.sin(phi) / m
    az = ft * jnp.cos(phi) / m - g
    aphi = l * (f1 - f2) / inertia
    vx2, vz2, w2 = vx + ax * dt, vz + az * dt, w + aphi * dt
    return jnp.stack([px + vx2 * dt, pz + vz2 * dt, phi + w2 * dt,
                      vx2, vz2, w2])
