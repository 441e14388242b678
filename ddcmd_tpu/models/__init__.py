"""Model families: programmatic deck builders for the working capability
set (LJ fluid, EAM metals, Martini CG water, Martini DPPC bilayer; CHARMM
chains come from RTF/PAR files via potentials.charmmfiles)."""

from .builders import (eam_crystal, equilibrated_bilayer, lj_fluid, load,
                       martini_bilayer, martini_water, write_atoms)

__all__ = ["eam_crystal", "equilibrated_bilayer", "lj_fluid", "load",
           "martini_bilayer", "martini_water", "write_atoms"]
