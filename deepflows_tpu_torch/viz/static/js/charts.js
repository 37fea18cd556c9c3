/* Declarative canvas chart engine (the role ECharts +
 * components/EChartsWrapper.vue play in the reference frontend).
 *
 * API intentionally ECharts-shaped: construct with an option object,
 * update data with setOption({series:[...]}) — the store/view layer stays
 * free of drawing code.
 *
 *   const chart = new LineChart(el, {
 *     series: [{ name: 'loss', color: '...', data: [], area: true }],
 *     yFormat: (v) => v.toFixed(2),     // optional tick/tooltip formatter
 *     yDomain: [0, 1],                  // optional fixed y range
 *   });
 *   chart.setOption({ series: [{ data: [...] }] });   // merge-by-index
 *
 * Rendering: retina-scaled 2D canvas, nice ticks, gridlines, legend,
 * nearest-point hover tooltip with a shared singleton tip element,
 * ResizeObserver-driven redraw.
 */

function niceTicks(min, max, target = 4) {
  if (!Number.isFinite(min) || !Number.isFinite(max)) return [];
  if (min === max) {
    min -= 1;
    max += 1;
  }
  const span = max - min;
  const mag = 10 ** Math.floor(Math.log10(span / target));
  const step =
    [1, 2, 5, 10].map((m) => m * mag).find((s) => span / s <= target + 1) ||
    mag * 10;
  const ticks = [];
  for (let v = Math.ceil(min / step) * step; v <= max + 1e-12; v += step) {
    ticks.push(v);
  }
  return ticks;
}

export function defaultFormat(v) {
  if (v === 0) return '0';
  const a = Math.abs(v);
  if (a >= 1000) return v.toFixed(0);
  if (a >= 1) return (+v.toFixed(2)).toString();
  if (a >= 0.01) return (+v.toFixed(3)).toString();
  return v.toExponential(1);
}

export function ema(data, alpha = 0.15) {
  const out = [];
  let m = null;
  for (const v of data) {
    m = m === null ? v : alpha * v + (1 - alpha) * m;
    out.push(m);
  }
  return out;
}

let tipEl = null;
function tip() {
  if (!tipEl) {
    tipEl = document.createElement('div');
    tipEl.className = 'chart-tooltip';
    document.body.append(tipEl);
  }
  return tipEl;
}

const PAD = { l: 46, r: 8, t: 8, b: 14 };

export class LineChart {
  constructor(el, option) {
    this.canvas = document.createElement('canvas');
    this.canvas.className = 'chart';
    el.append(this.canvas);
    this.option = { series: [], yFormat: defaultFormat, ...option };
    this._geo = null;
    this.canvas.addEventListener('mousemove', (e) => this._hover(e));
    this.canvas.addEventListener('mouseleave', () => {
      tip().style.display = 'none';
    });
    this._ro = new ResizeObserver(() => this.render());
    this._ro.observe(this.canvas);
    this.render();
  }

  dispose() {
    this._ro.disconnect();
    this.canvas.remove();
  }

  setOption(patch) {
    if (patch.series) {
      patch.series.forEach((s, i) => {
        this.option.series[i] = { ...this.option.series[i], ...s };
      });
      const rest = { ...patch };
      delete rest.series;
      Object.assign(this.option, rest);
    } else {
      Object.assign(this.option, patch);
    }
    this.render();
  }

  render() {
    const c = this.canvas;
    const g = c.getContext('2d');
    const dpr = window.devicePixelRatio || 1;
    const W = (c.width = Math.max(1, c.clientWidth * dpr));
    const H = (c.height = Math.max(1, c.clientHeight * dpr));
    g.clearRect(0, 0, W, H);
    const css = getComputedStyle(document.documentElement);
    const gridColor = css.getPropertyValue('--chart-grid').trim() || '#eee';
    const textColor = css.getPropertyValue('--chart-text').trim() || '#999';
    const pad = {
      l: PAD.l * dpr, r: PAD.r * dpr, t: PAD.t * dpr, b: PAD.b * dpr,
    };
    const live = this.option.series
      .map((s) => ({ ...s, vals: s.data || [] }))
      .filter((s) => s.vals.length);
    this._geo = null;
    if (!live.length) {
      g.fillStyle = textColor;
      g.font = `${11 * dpr}px system-ui`;
      g.fillText('no data yet', pad.l, H / 2);
      return;
    }
    const all = live.flatMap((s) => s.vals);
    let [min, max] = this.option.yDomain || [
      Math.min(...all),
      Math.max(...all),
    ];
    if (min === max) {
      min -= 1;
      max += 1;
    }
    const n = Math.max(...live.map((s) => s.vals.length));
    const X = (i) => pad.l + (n < 2 ? 0 : (i / (n - 1)) * (W - pad.l - pad.r));
    const Y = (v) => H - pad.b - ((v - min) / (max - min)) * (H - pad.t - pad.b);
    this._geo = { X, n, live, dpr };

    g.font = `${10 * dpr}px system-ui`;
    for (const t of niceTicks(min, max)) {
      g.strokeStyle = gridColor;
      g.beginPath();
      g.moveTo(pad.l, Y(t));
      g.lineTo(W - pad.r, Y(t));
      g.stroke();
      g.fillStyle = textColor;
      g.fillText(this.option.yFormat(t), 4 * dpr, Y(t) + 3 * dpr);
    }
    for (const s of live) {
      if (s.area) {
        g.fillStyle = s.color + '22';
        g.beginPath();
        g.moveTo(X(0), Y(min));
        s.vals.forEach((v, i) => g.lineTo(X(i), Y(v)));
        g.lineTo(X(s.vals.length - 1), Y(min));
        g.closePath();
        g.fill();
      }
      g.strokeStyle = s.color;
      g.lineWidth = (s.width || 1.6) * dpr;
      g.beginPath();
      s.vals.forEach((v, i) => (i ? g.lineTo(X(i), Y(v)) : g.moveTo(X(i), Y(v))));
      g.stroke();
    }
    let lx = pad.l + 6 * dpr;
    for (const s of live) {
      g.fillStyle = s.color;
      g.fillRect(lx, pad.t, 12 * dpr, 3 * dpr);
      g.fillStyle = textColor;
      g.fillText(s.name, lx + 16 * dpr, pad.t + 5 * dpr);
      lx += 24 * dpr + g.measureText(s.name).width;
    }
  }

  _hover(e) {
    if (!this._geo) return;
    const r = this.canvas.getBoundingClientRect();
    const { X, n, live, dpr } = this._geo;
    const px = (e.clientX - r.left) * dpr;
    let best = 0;
    let bd = Infinity;
    for (let i = 0; i < n; i++) {
      const d = Math.abs(X(i) - px);
      if (d < bd) {
        bd = d;
        best = i;
      }
    }
    const fmt = this.option.yFormat;
    const parts = live.map(
      (s) =>
        `${s.name}: ${s.vals[best] === undefined ? '—' : fmt(s.vals[best])}`,
    );
    const t = tip();
    t.textContent = `#${best}  ${parts.join('   ')}`;
    t.style.left = `${e.clientX + 12}px`;
    t.style.top = `${e.clientY - 10}px`;
    t.style.display = 'block';
  }
}
