"""The program's conv scenes of a configuration file's layers."""
from __future__ import annotations

from typing import Dict, Mapping


def scenes(config: Mapping, batch: int) -> Dict[str, object]:
    """``{layer name: ConvScene}`` at ``batch`` images, in layer order."""
    from repro_torch.core.scene import ConvScene
    return {layer["name"]: ConvScene(
        B=batch, IC=layer["IC"], OC=layer["OC"], inH=layer["inH"],
        inW=layer["inW"], fltH=layer["fltH"], fltW=layer["fltW"],
        padH=layer["padH"], padW=layer["padW"], stdH=layer["stdH"],
        stdW=layer["stdW"], dtype=config["dtype"])
        for layer in config["layers"]}
