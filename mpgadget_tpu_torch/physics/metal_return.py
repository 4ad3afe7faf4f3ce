"""Stellar mass & metal return: AGB winds, SNII, SN1a enrichment (PyTorch
port of mpgadget_tpu/physics/metal_return.py, after
libgadget/metal_return.c).

Each star particle returns mass and 9 metal species (H, He, C, N, O, Ne,
Mg, Si, Fe -- metal_tables.h:5) to its SPH-kernel gas neighbourhood as its
stellar population ages.  The stellar-evolution inputs are the JAX
package's: a Chabrier (2003) IMF, the Raiteri, Villata & Navarro (1996)
lifetimes, the Kalirai et al. (2008) initial-final mass relation, the
Kobayashi+06 / Karakas 2010 yield grids (physics/yield_tables.py) and a
Maoz, Mannucci & Brandt (2012) SN1a delay-time distribution with the
Iwamoto et al. (1999) W7 yields.

The per-step integral over dying masses is a 16-node Gauss-Legendre
quadrature over all stars at once, with the JAX package's float64
promotions (its numpy-scalar constants make the IMF and the sums
float64).  Spreading runs through the shared pair engine in two passes
over one tree of gas and stars: a star Hsml bisection (stellarhsml
analog; K3 walks, ops/pairs.pair_reduce sums) and a gas <- star
kernel-weighted gather (a symmetric K3 walk through the stars' node
hmax, then pair_reduce).
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import yield_tables as yt
from .cooling import _log10

NMETALS = 9
SPECIES = ("H", "He", "C", "N", "O", "Ne", "Mg", "Si", "Fe")

# Iwamoto et al. 1999 (W7 model) per-event SN1a yields in Msun
# (published constants; zero H/He).
SN1A_YIELDS = np.array([0.0, 0.0, 4.83e-2, 1.16e-6, 1.43e-1, 4.51e-3,
                        8.57e-3, 1.53e-1, 7.43e-1], np.float32)
SN1A_EJECTA = float(SN1A_YIELDS.sum())

MINMASS = 0.1       # IMF lower bound, Msun
MAXMASS = 40.0      # IMF upper bound (heavier collapse silently)
AGB_MAX = 8.0
SNII_MIN = 8.0
SN1A_INDEX = 1.1    # Maoz+12 DTD slope

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


# -- IMF (Chabrier 2003) ----------------------------------------------

def _chabrier_xi(m):
    """Number of stars per unit mass interval, unnormalized (numpy)."""
    lm = np.log10(m)
    low = (0.158 / (np.log(10) * m)
           * np.exp(-0.5 * ((lm - np.log10(0.079)) / 0.69) ** 2))
    A = (0.158 / np.log(10)
         * np.exp(-0.5 * (np.log10(1 / 0.079) / 0.69) ** 2))
    high = A * m ** -2.3
    return np.where(m < 1.0, low, high)


def _imf_mass_norm():
    m = np.geomspace(MINMASS, MAXMASS, 4096)
    return _trapezoid(m * _chabrier_xi(m), m)


IMF_MASS_NORM = _imf_mass_norm()    # Msun formed per "IMF unit"
_IMF_A = float(0.158 / np.log(10)
               * np.exp(-0.5 * (np.log10(1 / 0.079) / 0.69) ** 2))


def imf_xi(m):
    """Stars per Msun-formed per unit mass, float64 from float32 masses:
    the JAX package's float32 log10 and power, then its float64
    constants."""
    lm = _log10(m).double()
    md = m.double()
    low = (float(0.158 / np.log(10)) / md
           * torch.exp(-0.5 * ((lm - float(np.log10(0.079))) / 0.69) ** 2))
    high = _IMF_A * (m ** -2.3).double()
    return torch.where(m < 1.0, low, high) / float(IMF_MASS_NORM)


# -- lifetimes (Raiteri, Villata & Navarro 1996) ----------------------

def _lt_coeffs(zlog):
    a0 = 10.13 + 0.07547 * zlog - 0.008084 * zlog * zlog
    a1 = -4.424 - 0.7939 * zlog - 0.1187 * zlog * zlog
    a2 = 1.262 + 0.3385 * zlog + 0.05417 * zlog * zlog
    return a0, a1, a2


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def lifetime_myr(m, z):
    """Stellar lifetime in Myr for initial mass m (Msun), total
    metallicity z (clamped to the fit's validity range); float32."""
    z = _f32(z, m)
    zlog = _log10(torch.clamp(z, 7e-5, 0.03))
    a0, a1, a2 = _lt_coeffs(zlog)
    lm = _log10(torch.clamp(m, 0.08, 120.0))
    return torch.pow(10.0, a0 + a1 * lm + a2 * lm * lm) / 1e6


def mass_dying(t_myr, z):
    """Inverse of lifetime_myr: the mass whose lifetime is t (the fit's
    quadratic root in log10 m); float32."""
    z = _f32(z, t_myr)
    zlog = _log10(torch.clamp(z, 7e-5, 0.03))
    a0, a1, a2 = _lt_coeffs(zlog)
    c = a0 - _log10(torch.clamp(t_myr, 1e-3, 1e8) * 1e6)
    disc = torch.clamp(a1 * a1 - 4.0 * a2 * c, min=0.0)
    lm = (-a1 - torch.sqrt(disc)) / (2.0 * a2)
    return torch.clamp(torch.pow(10.0, lm), 0.0, 1e3)


# -- remnants & produced yields ---------------------------------------

def remnant_mass(m):
    """White dwarf (Kalirai+08 IFMR) below 8 Msun, neutron star / black
    hole above."""
    wd = 0.109 * m + 0.394
    ns = torch.where(m < 20.0, 1.4, 2.0 + 0.05 * (m - 20.0))
    return torch.where(m < SNII_MIN, wd, ns)


def produced_fractions(m, z_init=0.02):
    """Newly-synthesized mass per species (Msun) for a star of initial
    mass m and birth metallicity z_init, from the Kobayashi+06 SNII /
    Karakas 2010 AGB grids; index 0 (H) is zero.  Returns (list of 9
    tensors, ejecta)."""
    zi = torch.broadcast_to(_f32(z_init, m), m.shape)
    e = torch.clamp(m - remnant_mass(m), min=0.0)
    agb = m < SNII_MIN
    agb_t = yt.agb_produced(m, zi)
    sn_t = yt.snii_produced(m, zi)
    zero = torch.zeros_like(m)
    out = [zero] + [torch.where(agb, agb_t[k], sn_t[k])
                    for k in ("He", "C", "N", "O", "Ne", "Mg", "Si",
                              "Fe")]
    # never produce more than the ejecta
    tot = zero
    for o in out[1:]:
        tot = tot + o
    scale = torch.where(tot > 0.9 * e,
                        0.9 * e / torch.clamp(tot, min=1e-30), 1.0)
    return [o * scale for o in out], e


def sn1a_number(age0_myr, age1_myr, z, n0):
    """SN1a events per Msun formed in [age0, age1] (sn1a_number analog):
    t^-1.1 DTD from the 8-Msun lifetime to 13.7 Gyr, normalized to n0
    events per Msun over that window (Maoz+12); float32."""
    tau8 = lifetime_myr(torch.full_like(_f32(z, age0_myr), 8.0), z)
    tmax = np.float32(13.7e3)
    e = float(1 - np.float32(SN1A_INDEX))    # float32 arithmetic
    norm = tau8 ** e - float(tmax ** np.float32(e))
    t0 = torch.minimum(torch.maximum(age0_myr, tau8), _f32(tmax, tau8))
    t1 = torch.minimum(torch.maximum(age1_myr, tau8), _f32(tmax, tau8))
    frac = (t0 ** e - t1 ** e) / torch.clamp(norm, min=1e-30)
    return n0 * torch.clamp(frac, min=0.0)


# -- per-star return over one step ------------------------------------

_glx, _glw = np.polynomial.legendre.leggauss(16)
GL_X = _glx.astype(np.float32)
GL_W = _glw.astype(np.float32)


def stellar_return(age0_myr, age1_myr, z, m_init, sn1a_n0):
    """(mass_return, metals_generated[..., 9]) in mass units of m_init for
    stellar ages [age0, age1] Myr since formation; float64, as the JAX
    package's.  metals_generated[0] (H) stays zero: the caller fills in
    the unprocessed share from the star's birth composition."""
    age0_myr = age0_myr.to(torch.float32)
    age1_myr = age1_myr.to(torch.float32)
    z = z.to(torch.float32)
    m_init = m_init.to(torch.float32)
    dev = z.device
    m_hi = torch.clamp(mass_dying(torch.clamp(age0_myr, min=1e-2), z),
                       max=MAXMASS)
    m_lo = torch.clamp(mass_dying(torch.clamp(age1_myr, min=1e-2), z),
                       min=0.85)
    m_lo = torch.minimum(m_lo, m_hi)
    half = 0.5 * (m_hi - m_lo)
    mid = 0.5 * (m_hi + m_lo)
    glx = yt._dev(GL_X, dev)
    glw = yt._dev(GL_W, dev)
    nodes = mid[..., None] + half[..., None] * glx        # (..., 16)
    w = half[..., None] * glw
    xi = imf_xi(nodes)
    prod, ejecta = produced_fractions(nodes, z[..., None])
    wxi = w.double() * xi
    mret = torch.sum(wxi * ejecta.double(), dim=-1)
    gen = [torch.sum(wxi * p.double(), dim=-1) for p in prod]
    # SN1a: all-ejecta events, no remnant debit from the gas mass side
    nsn1a = sn1a_number(age0_myr, age1_myr, z, sn1a_n0)
    mret = mret + (nsn1a * SN1A_EJECTA).double()
    gen = [g + (nsn1a * float(y)).double()
           for g, y in zip(gen, SN1A_YIELDS)]
    gen = torch.stack(gen, dim=-1)
    md = m_init.double()
    return mret * md, gen * md[..., None]


# -- cosmic age table -------------------------------------------------

class AgeTable:
    """t(a) in Myr via one quadrature at construction
    (atime_integ/get_lifetime_in_myr, metal_return.c:150-170 analog);
    evaluated by float32 interpolation on the device.  Internal time
    units are s/h, hence the /HubbleParam."""

    def __init__(self, hubble_function, units, hubble_h, device="cuda"):
        loga = np.linspace(np.log(1e-3), 0.0, 512)
        a = np.exp(loga)
        # dloga / H -> internal time (s/h), then physical Myr
        integ = 1.0 / np.array([hubble_function(x) for x in a])
        t = np.concatenate([[0.0], np.cumsum(
            0.5 * (integ[1:] + integ[:-1]) * np.diff(loga))])
        sec_per_myr = 86400.0 * 365.25 * 1e6
        t_myr = t * units.UnitTime_in_s / hubble_h / sec_per_myr
        self.loga = torch.as_tensor(loga, dtype=torch.float32, device=device)
        self.t_myr = torch.as_tensor(t_myr, dtype=torch.float32,
                                     device=device)

    def __call__(self, a):
        from ..pm.gravity import interp
        if isinstance(a, torch.Tensor):
            x = torch.log(torch.clamp(a, 1e-3, 1.0))
        else:
            x = torch.as_tensor(np.log(np.clip(a, 1e-3, 1.0)),
                                device=self.loga.device)
        return interp(x.to(torch.float32).reshape(-1), self.loga,
                      self.t_myr).reshape(x.shape)


@dataclass(frozen=True)
class MetalReturnParams:
    sn1a_n0: float = 1.3e-3        # MetalsSn1aN0: SN1a per Msun formed
    sph_weighting: int = 1         # MetalsSPHWeighting
    max_ngb_deviation: float = 5.0
    ngb: float = 64.0              # target star neighbour count
    hsml_iter: int = 12
    group_max: int = 32
    leaf_list_max: int = 256
    leaf_eval_max: int = 16


def metal_return_step(ipos, mass, hsml_gas, gas_rho, is_gas, is_star,
                      star_hsml, stars, sph_metals, atime0, atime1,
                      age_table, boxsize, params: MetalReturnParams,
                      hubble_h=0.7, ll_static=None):
    """One metal-return step.  Returns a dict with the updated gas mass,
    gas metals, star mass, star bookkeeping fields and star hsml (input
    row order), as the JAX package's.

    ll_static: when set, the neighbour lists use this fixed capacity with
    overflow reported in "ngb_overflow" instead of the grow-and-retry."""
    from ..ops import pairs
    from ..sph import kernels as K
    from ..sph.density import group_radius, sorted_tree

    n = ipos.shape[0]
    G = params.group_max
    include = is_gas | is_star
    perm, inv, pos_box, include_s, tree, (leaf_nodes, gc, gh) = \
        sorted_tree(ipos, mass, include, G)
    LE = pairs.leaf_eval_cap(tree, params.leaf_eval_max)
    inv_box = 1.0 / boxsize
    ngb_ovf = torch.zeros((), dtype=torch.bool, device=ipos.device)
    is_gas_s = is_gas[perm]
    is_star_s = is_star[perm]
    mass_s = mass[perm]
    gmass_s = torch.where(is_gas_s, mass_s, 0.0)
    grho_s = torch.where(is_gas_s, gas_rho[perm], 1.0)

    # -- per-star return amounts (all stars at once) ------------------
    # (float32 in stellar_return, as the JAX package casts it there)
    m_init = (mass.double() + stars.total_mass_returned.double()).float()
    t_now = age_table(atime1)
    t_prev = age_table(atime0)
    t_birth = age_table(torch.clamp(stars.formation_time, 1e-3, 1.0))
    age0 = torch.clamp(t_prev - t_birth, min=0.0)
    age1 = torch.clamp(t_now - t_birth, min=0.0)
    zstar = torch.clamp(stars.metallicity, 0.0, 0.06)
    mret, gen = stellar_return(age0, age1, zstar, m_init,
                               params.sn1a_n0)
    active = is_star & (age1 > age0) & (mret > 0)
    # cap: never return more than 90% of the current star mass
    mret = torch.where(active, torch.minimum(mret, (0.9 * mass).double()),
                       0.0)
    gen = torch.where(active[:, None], gen, 0.0)
    # unprocessed ejecta carry the star's birth composition; H (index 0)
    # and the remainder of each species come from that share
    produced = torch.sum(gen, dim=1)
    unproc = torch.clamp(mret - produced, min=0.0)
    gen = gen + stars.metals.double() * unproc[:, None]

    # -- pass A: star hsml bisection (stellarhsml analog) -------------
    hsml_s = torch.where(is_star_s, star_hsml[perm], 0.0)
    ktype = K.CUBIC
    desngb = params.ngb
    dev = params.max_ngb_deviation
    left = torch.zeros(n, dtype=torch.float32, device=ipos.device)
    right = torch.full((n,), float("inf"), dtype=torch.float32,
                       device=ipos.device)
    done = ~is_star_s

    def count_pair_fn(dx, r, tmask, smask, tfeat, sfeat):
        hinv = 1.0 / torch.clamp(tfeat["hsml"], min=1e-30)
        u = r * hinv
        inside = (u < 1.0) & (sfeat["isgas"] > 0)
        wk = torch.where(inside, K.kernel_wk(u, hinv, ktype), 0.0)
        ngb = wk * K.NORM_COEFF / torch.clamp(hinv ** 3, min=1e-30)
        w = (sfeat["gmass"] / torch.clamp(sfeat["grho"], min=1e-30)
             if params.sph_weighting else torch.ones_like(wk))
        return {"ngb": ngb, "norm": wk * w}

    out = None
    for _ in range(params.hsml_iter):
        hsml_box = hsml_s * inv_box
        gradius = group_radius(tree, leaf_nodes, hsml_box, G)
        if ll_static is not None:
            nbr = pairs.spanned(
                "metal count", "K3", pairs.find_neighbors, tree,
                leaf_nodes, gc, gh, gradius, None, ll_static,
                symmetric=False)
            ngb_ovf = ngb_ovf | nbr.overflow.any()
        else:
            nbr, _ = pairs.spanned(
                "metal count", "K3", pairs.find_neighbors_auto, tree,
                leaf_nodes, gc, gh, gradius, None, params.leaf_list_max,
                symmetric=False, cache_key=("metal_hsml", n))
        out = pairs.spanned(
            "metal count", "pair_reduce", pairs.pair_reduce,
            count_pair_fn, nbr, tree, pos_box, {"hsml": hsml_box},
            {"isgas": is_gas_s.to(torch.float32), "gmass": gmass_s,
             "grho": grho_s},
            {"ngb": "sum", "norm": "sum"}, G, LE)
        numngb = out["ngb"]
        converged = (torch.abs(numngb - desngb) <= dev) | done
        low = numngb < desngb - dev
        high = numngb > desngb + dev
        hb = hsml_s * inv_box
        left = torch.where(low & ~done, hb, left)
        right = torch.where(high & ~done, hb, right)
        have_both = (right < float("inf")) & (left > 0)
        h_new = torch.where(
            have_both, (0.5 * (left ** 3 + right ** 3)) ** (1.0 / 3.0),
            torch.where(low, hb * 1.26, hb / 1.26))
        h_new = torch.clamp(h_new, 1e-6, 0.2)
        hsml_s = torch.where(converged, hsml_s, h_new * boxsize)
        done = converged
        if bool(done.all()):
            break

    norm_s = torch.clamp(out["norm"], min=0.0)

    # -- pass B: gas <- star spread (gather formulation) --------------
    # node hmax over star hsml so that the symmetric search finds every
    # star whose kernel reaches the gas group (treewalk.h:13-16)
    lf_ids, n_lf, _ = pairs.compact_leaves(tree, 2 * n + 64)
    hmax = pairs.node_hmax(tree, lf_ids, n_lf,
                           torch.where(is_star_s, hsml_s * inv_box, 0.0))
    mret_s = mret[perm]
    gen_s = gen[perm]

    def spread_pair_fn(dx, r, tmask, smask, tfeat, sfeat):
        hinv = 1.0 / torch.clamp(sfeat["hsml"], min=1e-30)
        u = r * hinv
        inside = (u < 1.0) & (sfeat["isstar"] > 0) & (sfeat["norm"] > 0)
        wk = torch.where(inside, K.kernel_wk(u, hinv, ktype), 0.0)
        w = (tfeat["gmass"] / torch.clamp(tfeat["grho"], min=1e-30)
             if params.sph_weighting else torch.ones_like(wk))
        wgt = wk * w / torch.clamp(sfeat["norm"], min=1e-30)
        res = {"dmass": wgt * sfeat["mret"]}
        for i in range(NMETALS):
            res[f"dz{i}"] = wgt * sfeat["gen"][..., i]
        return res

    reducers = {"dmass": "sum"}
    reducers.update({f"dz{i}": "sum" for i in range(NMETALS)})
    zeros = torch.zeros(gc.shape[0], dtype=torch.float32, device=gc.device)
    if ll_static is not None:
        nbr2 = pairs.spanned(
            "metal spread", "K3", pairs.find_neighbors, tree, leaf_nodes,
            gc, gh, zeros, hmax, ll_static, symmetric=True)
        ngb_ovf = ngb_ovf | nbr2.overflow.any()
    else:
        nbr2, _ = pairs.spanned(
            "metal spread", "K3", pairs.find_neighbors_auto, tree,
            leaf_nodes, gc, gh, zeros, hmax, params.leaf_list_max,
            symmetric=True, cache_key=("metal_spread", n))
    sp = pairs.spanned(
        "metal spread", "pair_reduce", pairs.pair_reduce, spread_pair_fn,
        nbr2, tree, pos_box, {"gmass": gmass_s, "grho": grho_s},
        {"hsml": hsml_s * inv_box, "isstar": is_star_s.to(torch.float32),
         "norm": norm_s, "mret": mret_s, "gen": gen_s},
        reducers, G, LE)

    dmass = torch.where(is_gas_s, sp["dmass"], 0.0)[inv]
    dmetals = torch.stack([sp[f"dz{i}"] for i in range(NMETALS)], dim=-1)
    dmetals = torch.where(is_gas_s[:, None], dmetals, 0.0)[inv]

    # stars with gas neighbours actually returned; others keep their mass
    returned = torch.where(norm_s[inv] > 0, mret, 0.0)
    new_gas_mass = mass + dmass
    new_metals = torch.where(
        is_gas[:, None],
        (sph_metals * mass[:, None] + dmetals)
        / torch.clamp(new_gas_mass, min=1e-30)[:, None],
        sph_metals)
    return {
        "gas_mass": torch.where(is_gas, new_gas_mass, mass),
        "gas_metals": new_metals,
        "star_mass": torch.where(is_star, mass.double() - returned,
                                 mass.double()),
        "total_mass_returned":
            stars.total_mass_returned.double() + returned,
        "last_enrichment_myr": torch.where(active, age1,
                                           stars.last_enrichment_myr),
        "star_hsml": torch.where(is_star_s, hsml_s, 0.0)[inv],
        "mass_returned_total": torch.sum(returned),
        "mass_received_total": torch.sum(dmass),
        "ngb_overflow": ngb_ovf,
    }
