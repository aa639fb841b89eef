"""Declarative UI component library — charts/tables/text as JSON.

The port's copy of deeplearning4j_tpu/ui/components.py, the equivalent of
reference deeplearning4j-ui-components
(components/chart/{ChartLine,ChartScatter,ChartHistogram,ChartStackedArea,
ChartTimeline}.java, components/table/ComponentTable.java,
components/text/ComponentText.java, ComponentDiv.java): Java objects
serialized to JSON which a JS front-end renders. Here each component is a
small Python object with the same JSON contract (type tag + config), a
from_dict registry for round-trips, and `render_html` which emits a
standalone page rendering every component with the same SVG helpers the
training UI uses (the StatsUtils.exportStatsAsHtml role).
"""
from __future__ import annotations

import json

_REGISTRY = {}


def _register(cls):
    _REGISTRY[cls.type_name] = cls
    return cls


class Component:
    type_name = "Component"

    def to_dict(self):
        raise NotImplementedError

    def to_json(self):
        return json.dumps(self.to_dict())

    toJson = to_json

    @staticmethod
    def from_dict(d):
        cls = _REGISTRY.get(d.get("componentType"))
        if cls is None:
            raise ValueError(f"Unknown component type "
                             f"{d.get('componentType')!r}")
        return cls._from(d)

    @staticmethod
    def from_json(s):
        return Component.from_dict(json.loads(s))

    fromJson = from_json


@_register
class ComponentText(Component):
    """reference: components/text/ComponentText.java"""

    type_name = "ComponentText"

    def __init__(self, text, style=None):
        self.text = str(text)
        self.style = style or {}

    def to_dict(self):
        return {"componentType": self.type_name, "text": self.text,
                "style": self.style}

    @classmethod
    def _from(cls, d):
        return cls(d["text"], d.get("style"))


@_register
class ComponentTable(Component):
    """reference: components/table/ComponentTable.java"""

    type_name = "ComponentTable"

    def __init__(self, header, content, title=None):
        self.header = [str(h) for h in header]
        self.content = [[str(c) for c in row] for row in content]
        self.title = title

    def to_dict(self):
        return {"componentType": self.type_name, "header": self.header,
                "content": self.content, "title": self.title}

    @classmethod
    def _from(cls, d):
        return cls(d["header"], d["content"], d.get("title"))


class _BaseChart(Component):
    def __init__(self, title=None, x_label=None, y_label=None):
        self.title = title
        self.x_label = x_label
        self.y_label = y_label

    def _base_dict(self):
        return {"componentType": self.type_name, "title": self.title,
                "xLabel": self.x_label, "yLabel": self.y_label}


@_register
class ChartLine(_BaseChart):
    """reference: components/chart/ChartLine.java — named series."""

    type_name = "ChartLine"

    def __init__(self, title=None, x_label=None, y_label=None):
        super().__init__(title, x_label, y_label)
        self.series = []    # (name, xs, ys)

    def add_series(self, name, x, y):
        self.series.append((str(name), [float(v) for v in x],
                            [float(v) for v in y]))
        return self

    addSeries = add_series

    def to_dict(self):
        d = self._base_dict()
        d["series"] = [{"name": n, "x": x, "y": y}
                       for n, x, y in self.series]
        return d

    @classmethod
    def _from(cls, d):
        c = cls(d.get("title"), d.get("xLabel"), d.get("yLabel"))
        for s in d.get("series", []):
            c.add_series(s["name"], s["x"], s["y"])
        return c


@_register
class ChartScatter(ChartLine):
    """reference: components/chart/ChartScatter.java"""

    type_name = "ChartScatter"


@_register
class ChartStackedArea(ChartLine):
    """reference: components/chart/ChartStackedArea.java"""

    type_name = "ChartStackedArea"


@_register
class ChartHistogram(_BaseChart):
    """reference: components/chart/ChartHistogram.java — explicit bins."""

    type_name = "ChartHistogram"

    def __init__(self, title=None, x_label=None, y_label=None):
        super().__init__(title, x_label, y_label)
        self.bins = []     # (low, high, count)

    def add_bin(self, low, high, count):
        self.bins.append((float(low), float(high), float(count)))
        return self

    addBin = add_bin

    def to_dict(self):
        d = self._base_dict()
        d["bins"] = [{"low": lo, "high": hi, "count": c}
                     for lo, hi, c in self.bins]
        return d

    @classmethod
    def _from(cls, d):
        c = cls(d.get("title"), d.get("xLabel"), d.get("yLabel"))
        for b in d.get("bins", []):
            c.add_bin(b["low"], b["high"], b["count"])
        return c


@_register
class ChartTimeline(_BaseChart):
    """reference: components/chart/ChartTimeline.java — lanes of
    [start, end, label] entries (the Spark phase-timeline renderer)."""

    type_name = "ChartTimeline"

    def __init__(self, title=None):
        super().__init__(title)
        self.lanes = []    # (lane name, [(start, end, label)])

    def add_lane(self, name, entries):
        self.lanes.append((str(name),
                           [(float(s), float(e), str(lb))
                            for s, e, lb in entries]))
        return self

    addLane = add_lane

    def to_dict(self):
        d = self._base_dict()
        d["lanes"] = [{"name": n,
                       "entries": [{"start": s, "end": e, "label": lb}
                                   for s, e, lb in ents]}
                      for n, ents in self.lanes]
        return d

    @classmethod
    def _from(cls, d):
        c = cls(d.get("title"))
        for lane in d.get("lanes", []):
            c.add_lane(lane["name"],
                       [(e["start"], e["end"], e["label"])
                        for e in lane["entries"]])
        return c


@_register
class ComponentDiv(Component):
    """Container of components — reference ComponentDiv.java."""

    type_name = "ComponentDiv"

    def __init__(self, *children, style=None):
        self.children = list(children)
        self.style = style or {}

    def to_dict(self):
        return {"componentType": self.type_name, "style": self.style,
                "components": [c.to_dict() for c in self.children]}

    @classmethod
    def _from(cls, d):
        return cls(*[Component.from_dict(c)
                     for c in d.get("components", [])],
                   style=d.get("style"))


def render_html(components, title="Components"):
    """Standalone HTML rendering every component — the
    StatsUtils.exportStatsAsHtml role. Data is embedded as JSON and drawn
    client-side with the same safe DOM helpers as the training UI."""
    import html as _html

    from .server import _JS_LIB, _STYLE
    # '<' escaped so an embedded '</script>' in component text cannot
    # terminate the JSON island and inject live HTML into the report
    payload = json.dumps([c.to_dict() for c in components]).replace(
        "<", "\\u003c")
    title = _html.escape(str(title))
    script = _JS_LIB + """
const comps = JSON.parse(document.getElementById('data').textContent);
const root = document.getElementById('root');
function render(c, parent){
 const card = el('div'); card.className='card';
 if(c.title) card.appendChild(el('h2', c.title));
 if(c.componentType==='ComponentText'){
  card.appendChild(el('p', c.text));
 } else if(c.componentType==='ComponentTable'){
  const t=el('table'); const hr=el('tr');
  for(const h of c.header) hr.appendChild(el('th',h));
  t.appendChild(hr);
  for(const row of c.content){const tr=el('tr');
   for(const v of row) tr.appendChild(el('td',v)); t.appendChild(tr);}
  card.appendChild(t);
 } else if(c.componentType==='ChartLine'||c.componentType==='ChartScatter'
           ||c.componentType==='ChartStackedArea'){
  const svg=document.createElementNS('http://www.w3.org/2000/svg','svg');
  card.appendChild(svg);
  const colors=['#06c','#083','#c60','#638','#a40'];
  c.series.forEach((s,i)=>{
   const pts=s.x.map((x,k)=>[x,s.y[k]]);
   if(c.componentType==='ChartScatter') drawScatter(svg, pts);
   else drawLine(svg, pts, colors[i%colors.length]);});
 } else if(c.componentType==='ChartHistogram'){
  const svg=document.createElementNS('http://www.w3.org/2000/svg','svg');
  card.appendChild(svg);
  if(c.bins.length)
   drawHistogram(svg, c.bins.map(b=>b.count), c.bins[0].low,
                 c.bins[c.bins.length-1].high);
 } else if(c.componentType==='ChartTimeline'){
  const t=el('table');
  for(const lane of c.lanes){const tr=el('tr');
   tr.appendChild(el('th', lane.name));
   for(const e of lane.entries)
    tr.appendChild(el('td', e.label+' ['+e.start+'-'+e.end+']'));
   t.appendChild(tr);}
  card.appendChild(t);
 } else if(c.componentType==='ComponentDiv'){
  for(const ch of c.components) render(ch, card);
 }
 parent.appendChild(card);
}
for(const c of comps) render(c, root);
"""
    return (f"<!DOCTYPE html><html><head><title>{title}</title>"
            f"<style>{_STYLE}</style></head><body><div id='root'></div>"
            f"<script type='application/json' id='data'>{payload}</script>"
            f"<script>{script}</script></body></html>")
