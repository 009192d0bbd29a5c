"""hp-domain-decomposition geometry: element grids, affine maps, jacobians.

Covers the reference's grid construction and per-element affine mapping
(Poisson-1D.py:264-273 and the per-element maps at Poisson-1D.py:69-71,
Poisson-2D.py:75-79): elements partition each axis, the reference element
xi in [-1,1] maps to x = x_e + (x_{e+1}-x_e)/2 * (xi+1) with jacobian
(x_{e+1}-x_e)/2 per axis.  Non-uniform grids (the reference's 3-element
[-1,-0.1,0.1,1] special case, Poisson-1D.py:270-273) are first-class.

All per-element quantities are materialized as arrays with a leading element
axis — the device sharding/vmap axis — instead of the reference's Python loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def uniform_grid(lo: float, hi: float, n_elem: int) -> np.ndarray:
    """Uniform element boundaries, matching Poisson-1D.py:266-267."""
    return lo + (hi - lo) / n_elem * np.arange(n_elem + 1, dtype=np.float64)


@dataclass(frozen=True)
class Interval1D:
    """A 1D element partition.

    grid: [E+1] element boundaries (possibly non-uniform).
    """

    grid: np.ndarray

    def __post_init__(self):
        grid = np.asarray(self.grid, dtype=np.float64)
        object.__setattr__(self, "grid", grid)
        if grid.ndim != 1 or len(grid) < 2:
            raise ValueError(f"grid needs >= 2 boundaries, got shape {grid.shape}")
        if not np.all(np.diff(grid) > 0):
            raise ValueError(f"grid must be strictly increasing, got {grid}")

    @classmethod
    def uniform(cls, lo: float, hi: float, n_elem: int) -> "Interval1D":
        return cls(grid=uniform_grid(lo, hi, n_elem))

    @property
    def n_elem(self) -> int:
        return len(self.grid) - 1

    @property
    def jacobians(self) -> np.ndarray:
        """[E] per-element jacobian (x_{e+1}-x_e)/2 (Poisson-1D.py:71)."""
        return np.diff(self.grid) / 2.0

    @property
    def centers(self) -> np.ndarray:
        return (self.grid[:-1] + self.grid[1:]) / 2.0

    def map_points(self, xi: np.ndarray) -> np.ndarray:
        """Map reference points xi [Q] into every element: returns [E, Q]."""
        xi = np.asarray(xi, dtype=np.float64).reshape(-1)
        return self.centers[:, None] + self.jacobians[:, None] * xi[None, :]

    def element_bounds(self) -> np.ndarray:
        """[E, 2] physical (left, right) endpoints of each element."""
        return np.stack([self.grid[:-1], self.grid[1:]], axis=-1)

    def locate(self, x: np.ndarray) -> np.ndarray:
        """Element index containing each x (for per-subdomain evaluation)."""
        idx = np.searchsorted(self.grid, x, side="right") - 1
        return np.clip(idx, 0, self.n_elem - 1)


@dataclass(frozen=True)
class TensorMesh2D:
    """Tensor-product 2D partition (x-axis x y/t-axis), as in
    Poisson-2D.py:369-378 / AdvDiff.py:403-411.

    Elements are enumerated flat with e = ex * E_y + ey (x-major, matching
    the reference's `for ex: for ey:` loop order, Poisson-2D.py:69-70).
    """

    axis_x: Interval1D
    axis_y: Interval1D

    @classmethod
    def uniform(cls, xlo, xhi, nex, ylo, yhi, ney) -> "TensorMesh2D":
        return cls(
            axis_x=Interval1D.uniform(xlo, xhi, nex),
            axis_y=Interval1D.uniform(ylo, yhi, ney),
        )

    @property
    def n_elem(self) -> int:
        return self.axis_x.n_elem * self.axis_y.n_elem

    @property
    def shape(self):
        return (self.axis_x.n_elem, self.axis_y.n_elem)

    def jacobians(self):
        """Per-axis jacobians for every flat element: ([E], [E])."""
        jx = np.repeat(self.axis_x.jacobians, self.axis_y.n_elem)
        jy = np.tile(self.axis_y.jacobians, self.axis_x.n_elem)
        return jx, jy

    def element_bounds(self):
        """Per-axis physical bounds for every flat element: ([E, 2], [E, 2]).

        Needed by weak forms with live element-boundary flux terms (the exact
        twice-IBP form '2c'; the reference sketches the analogous boundary
        tensors at AdvDiff.py:132-154 but never uses them)."""
        bx = np.repeat(self.axis_x.element_bounds(), self.axis_y.n_elem, axis=0)
        by = np.tile(self.axis_y.element_bounds(), (self.axis_x.n_elem, 1))
        return bx, by

    def map_points(self, xi: np.ndarray, eta: np.ndarray):
        """Map reference tensor grid (xi [Qx], eta [Qy]) into every element.

        Returns (X, Y) each of shape [E, Qy, Qx] — y (eta) is the slow
        point axis, matching the reference's np.meshgrid(X_quad, Y_quad)
        row-major flattening (Poisson-2D.py:362-364), where q = qy*Qx + qx.
        """
        Xx = self.axis_x.map_points(xi)  # [Ex, Qx]
        Yy = self.axis_y.map_points(eta)  # [Ey, Qy]
        Ex, Qx = Xx.shape
        Ey, Qy = Yy.shape
        X = np.broadcast_to(
            Xx[:, None, None, :], (Ex, Ey, Qy, Qx)
        ).reshape(Ex * Ey, Qy, Qx)
        Y = np.broadcast_to(
            Yy[None, :, :, None], (Ex, Ey, Qy, Qx)
        ).reshape(Ex * Ey, Qy, Qx)
        return np.ascontiguousarray(X), np.ascontiguousarray(Y)


@dataclass(frozen=True)
class TensorMesh3D:
    """Tensor-product 3D partition (x × y × z), generalizing TensorMesh2D.

    Elements enumerated flat with e = (ex * E_y + ey) * E_z + ez (x-major,
    consistent with the 2D convention).
    """

    axis_x: Interval1D
    axis_y: Interval1D
    axis_z: Interval1D

    @classmethod
    def uniform(cls, xlo, xhi, nex, ylo, yhi, ney, zlo, zhi, nez) -> "TensorMesh3D":
        return cls(
            axis_x=Interval1D.uniform(xlo, xhi, nex),
            axis_y=Interval1D.uniform(ylo, yhi, ney),
            axis_z=Interval1D.uniform(zlo, zhi, nez),
        )

    @property
    def n_elem(self) -> int:
        return self.axis_x.n_elem * self.axis_y.n_elem * self.axis_z.n_elem

    @property
    def shape(self):
        return (self.axis_x.n_elem, self.axis_y.n_elem, self.axis_z.n_elem)

    def jacobians(self):
        """Per-axis jacobians for every flat element: ([E], [E], [E])."""
        Ex, Ey, Ez = self.shape
        jx = np.repeat(self.axis_x.jacobians, Ey * Ez)
        jy = np.tile(np.repeat(self.axis_y.jacobians, Ez), Ex)
        jz = np.tile(self.axis_z.jacobians, Ex * Ey)
        return jx, jy, jz

    def map_points(self, xi: np.ndarray, eta: np.ndarray, zeta: np.ndarray):
        """Map reference tensor grid into every element.

        Returns (X, Y, Z) each [E, Qz, Qy, Qx] — z slowest point axis, x
        fastest, extending the 2D meshgrid convention.
        """
        Xx = self.axis_x.map_points(xi)   # [Ex, Qx]
        Yy = self.axis_y.map_points(eta)  # [Ey, Qy]
        Zz = self.axis_z.map_points(zeta)  # [Ez, Qz]
        Ex, Qx = Xx.shape
        Ey, Qy = Yy.shape
        Ez, Qz = Zz.shape
        E = Ex * Ey * Ez
        shape = (Ex, Ey, Ez, Qz, Qy, Qx)
        X = np.broadcast_to(Xx[:, None, None, None, None, :], shape).reshape(E, Qz, Qy, Qx)
        Y = np.broadcast_to(Yy[None, :, None, None, :, None], shape).reshape(E, Qz, Qy, Qx)
        Z = np.broadcast_to(Zz[None, None, :, :, None, None], shape).reshape(E, Qz, Qy, Qx)
        return (
            np.ascontiguousarray(X),
            np.ascontiguousarray(Y),
            np.ascontiguousarray(Z),
        )
