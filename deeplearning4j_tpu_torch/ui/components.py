"""Declarative UI component model: charts / tables / text as JSON, plus a
self-contained HTML renderer (the JAX package's ``ui/components.py``; the
same JSON and the same page for the same components).

Ref: deeplearning4j-ui-components — component JSON model
(components/chart/{Chart,ChartLine,ChartScatter,ChartHistogram,
ChartHorizontalBar,ChartStackedArea,ChartTimeline}.java,
components/table/ComponentTable.java, components/text/ComponentText.java,
component/ComponentDiv.java) rendered by TypeScript/d3 assets. Here the
model serializes to the same kind of typed-JSON dict and ``render_html``
emits one dependency-free page (inline SVG, no d3 — zero-egress).
"""

from __future__ import annotations

import html as _html
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class Component:
    """Base: every component serializes as {"type": ..., ...fields}."""

    type: str = "Component"

    def to_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "Component":
        t = d.get("type")
        cls = _REGISTRY.get(t)
        if cls is None:
            raise ValueError(f"Unknown component type {t!r}")
        return cls._from_dict(d)


_REGISTRY: Dict[str, type] = {}


def _register(cls):
    _REGISTRY[cls.type] = cls
    return cls


@_register
@dataclass
class ComponentText(Component):
    """ref: components/text/ComponentText.java."""
    text: str = ""
    type = "ComponentText"

    def to_dict(self):
        return {"type": self.type, "text": self.text}

    @classmethod
    def _from_dict(cls, d):
        return cls(text=d["text"])


@_register
@dataclass
class ComponentTable(Component):
    """ref: components/table/ComponentTable.java."""
    header: List[str] = field(default_factory=list)
    content: List[List[str]] = field(default_factory=list)
    title: str = ""
    type = "ComponentTable"

    def to_dict(self):
        return {"type": self.type, "title": self.title,
                "header": list(self.header),
                "content": [list(r) for r in self.content]}

    @classmethod
    def _from_dict(cls, d):
        return cls(header=d["header"], content=d["content"],
                   title=d.get("title", ""))


@dataclass
class _ChartBase(Component):
    title: str = ""
    x_label: str = ""
    y_label: str = ""

    def _base_dict(self):
        return {"type": self.type, "title": self.title,
                "xLabel": self.x_label, "yLabel": self.y_label}


@_register
@dataclass
class ChartLine(_ChartBase):
    """Named (x, y) series (ref: chart/ChartLine.java Builder.addSeries)."""
    series: List[Tuple[str, List[float], List[float]]] = field(
        default_factory=list)
    type = "ChartLine"

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "ChartLine":
        if len(x) != len(y):
            raise ValueError(f"series {name!r}: {len(x)} x vs {len(y)} y")
        self.series.append((name, [float(v) for v in x],
                            [float(v) for v in y]))
        return self

    def to_dict(self):
        d = self._base_dict()
        d["series"] = [{"name": n, "x": x, "y": y} for n, x, y in self.series]
        return d

    @classmethod
    def _from_dict(cls, d):
        c = cls(title=d.get("title", ""), x_label=d.get("xLabel", ""),
                y_label=d.get("yLabel", ""))
        for s in d["series"]:
            c.add_series(s["name"], s["x"], s["y"])
        return c


@_register
@dataclass
class ChartScatter(ChartLine):
    """ref: chart/ChartScatter.java — same payload, point rendering."""
    type = "ChartScatter"


@_register
@dataclass
class ChartHistogram(_ChartBase):
    """Bins as (lower, upper, count) (ref: chart/ChartHistogram.java)."""
    bins: List[Tuple[float, float, float]] = field(default_factory=list)
    type = "ChartHistogram"

    def add_bin(self, lower: float, upper: float,
                y_value: float) -> "ChartHistogram":
        self.bins.append((float(lower), float(upper), float(y_value)))
        return self

    def to_dict(self):
        d = self._base_dict()
        d["bins"] = [{"lower": l, "upper": u, "y": y} for l, u, y in self.bins]
        return d

    @classmethod
    def _from_dict(cls, d):
        c = cls(title=d.get("title", ""), x_label=d.get("xLabel", ""),
                y_label=d.get("yLabel", ""))
        for b in d["bins"]:
            c.add_bin(b["lower"], b["upper"], b["y"])
        return c


@_register
@dataclass
class ChartHorizontalBar(_ChartBase):
    """Category -> value bars (ref: chart/ChartHorizontalBar.java)."""
    categories: List[str] = field(default_factory=list)
    values: List[float] = field(default_factory=list)
    type = "ChartHorizontalBar"

    def add_bar(self, name: str, value: float) -> "ChartHorizontalBar":
        self.categories.append(name)
        self.values.append(float(value))
        return self

    def to_dict(self):
        d = self._base_dict()
        d["categories"] = list(self.categories)
        d["values"] = list(self.values)
        return d

    @classmethod
    def _from_dict(cls, d):
        c = cls(title=d.get("title", ""))
        for n, v in zip(d["categories"], d["values"]):
            c.add_bar(n, v)
        return c


@_register
@dataclass
class ComponentDiv(Component):
    """Container (ref: component/ComponentDiv.java)."""
    children: List[Component] = field(default_factory=list)
    type = "ComponentDiv"

    def add(self, *components: Component) -> "ComponentDiv":
        self.children.extend(components)
        return self

    def to_dict(self):
        return {"type": self.type,
                "children": [c.to_dict() for c in self.children]}

    @classmethod
    def _from_dict(cls, d):
        return cls(children=[Component.from_dict(c) for c in d["children"]])


# ---------------------------------------------------------------------------
# rendering (the d3/TypeScript assets' role, as inline SVG)
# ---------------------------------------------------------------------------

_COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
           "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]


def _svg_chart(series, title, scatter=False, w=640, h=260, pad=40) -> str:
    xs = [v for _, x, _ in series for v in x]
    ys = [v for _, _, y in series for v in y]
    if not xs:
        return f"<svg width='{w}' height='{h}'></svg>"
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 == x0:
        x1 = x0 + 1
    if y1 == y0:
        y1 = y0 + 1
    sx = lambda v: pad + (v - x0) / (x1 - x0) * (w - 2 * pad)
    sy = lambda v: h - pad - (v - y0) / (y1 - y0) * (h - 2 * pad)
    parts = [f"<svg width='{w}' height='{h}' style='background:#fff'>"]
    parts.append(f"<text x='{w//2}' y='16' text-anchor='middle' "
                 f"font-size='13'>{_html.escape(title)}</text>")
    parts.append(f"<line x1='{pad}' y1='{h-pad}' x2='{w-pad}' y2='{h-pad}' "
                 "stroke='#999'/>"
                 f"<line x1='{pad}' y1='{pad}' x2='{pad}' y2='{h-pad}' "
                 "stroke='#999'/>")
    for i, (name, x, y) in enumerate(series):
        color = _COLORS[i % len(_COLORS)]
        if scatter:
            for px, py in zip(x, y):
                parts.append(f"<circle cx='{sx(px):.1f}' cy='{sy(py):.1f}' "
                             f"r='2.5' fill='{color}'/>")
        else:
            pts = " ".join(f"{sx(px):.1f},{sy(py):.1f}"
                           for px, py in zip(x, y))
            parts.append(f"<polyline points='{pts}' fill='none' "
                         f"stroke='{color}' stroke-width='1.5'/>")
        parts.append(f"<text x='{w-pad+4}' y='{pad+14*i}' font-size='11' "
                     f"fill='{color}'>{_html.escape(name)}</text>")
    parts.append("</svg>")
    return "".join(parts)


def render_component_html(c: Component) -> str:
    """One component -> HTML fragment."""
    if isinstance(c, ComponentText):
        return f"<p>{_html.escape(c.text)}</p>"
    if isinstance(c, ComponentTable):
        head = "".join(f"<th>{_html.escape(str(h))}</th>" for h in c.header)
        rows = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(str(v))}</td>" for v in r)
            + "</tr>" for r in c.content)
        cap = f"<caption>{_html.escape(c.title)}</caption>" if c.title else ""
        return (f"<table border='1' cellspacing='0' cellpadding='4'>{cap}"
                f"<tr>{head}</tr>{rows}</table>")
    if isinstance(c, ChartScatter):
        return _svg_chart(c.series, c.title, scatter=True)
    if isinstance(c, ChartLine):
        return _svg_chart(c.series, c.title)
    if isinstance(c, ChartHistogram):
        series = [("", [(l + u) / 2 for l, u, _ in c.bins],
                   [y for _, _, y in c.bins])]
        return _svg_chart(series, c.title)
    if isinstance(c, ChartHorizontalBar):
        series = [("", list(range(len(c.values))), c.values)]
        return _svg_chart(series, c.title)
    if isinstance(c, ComponentDiv):
        return ("<div>" + "".join(render_component_html(x)
                                  for x in c.children) + "</div>")
    raise ValueError(f"Cannot render {type(c).__name__}")


def render_html(components: Sequence[Component], title: str = "Report",
                path: Optional[str] = None) -> str:
    """Full page (the StatsUtils.exportStatsAsHTML analog,
    ref: spark StatsUtils.java:445)."""
    body = "\n".join(render_component_html(c) for c in components)
    page = (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title></head>"
            f"<body style='font-family:sans-serif'>{body}</body></html>")
    if path:
        with open(path, "w") as f:
            f.write(page)
    return page
