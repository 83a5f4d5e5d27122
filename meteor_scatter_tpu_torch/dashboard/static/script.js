/* Dashboard frontend — feature parity with the reference static/js/script.js:
 * chart fetching with cache busting, periodic refresh of charts and the
 * missing-days list, a slideshow mixing dynamic charts with static slides
 * (ref index.html:51-57) including dot indicators (ref script.js:101-124),
 * configurable interval, 1 Hz clock. */

(function () {
  "use strict";

  var CHART_TYPES = ["tagesverlauf", "week", "month"];
  /* dynamic chart slides + the three static slides, like the reference */
  var SLIDES = CHART_TYPES.map(function (t) {
    return { kind: "chart", key: t, label: t };
  }).concat([1, 2, 3].map(function (i) {
    return { kind: "static", key: "folie" + i, label: "info " + i,
             url: "/static/slides/Folie" + i + ".png" };
  }));

  var chartUrls = {};
  var slideIndex = 0;
  var slideshowTimer = null;
  var slideshowInterval = 10000;
  var paused = false;

  function apiUrl(path) {
    return (SCRIPT_ROOT || "") + path;
  }

  /* fetch a chart and cache-bust the returned image URL (ref :10-41) */
  function loadChart(type, cb) {
    fetch(apiUrl("/load_chart/" + type))
      .then(function (r) { return r.json(); })
      .then(function (data) {
        if (data.img_url) {
          chartUrls[type] = data.img_url + "?t=" + Date.now();
          if (cb) cb(chartUrls[type]);
        }
      })
      .catch(function (e) { console.error("chart " + type + ":", e); });
  }

  /* dot indicators (ref :103-124) */
  function buildDots() {
    var holder = document.getElementById("slide-dots");
    holder.innerHTML = "";
    SLIDES.forEach(function (s, i) {
      var dot = document.createElement("span");
      dot.className = "dot";
      dot.addEventListener("click", function () { showSlide(i); });
      holder.appendChild(dot);
    });
  }

  function markDot(i) {
    var dots = document.getElementById("slide-dots").children;
    for (var k = 0; k < dots.length; k++) {
      dots[k].className = k === i ? "dot active" : "dot";
    }
  }

  function showSlide(i) {
    slideIndex = (i + SLIDES.length) % SLIDES.length;
    var slide = SLIDES[slideIndex];
    var img = document.getElementById("slide-img");
    var label = document.getElementById("slide-label");
    if (slide.kind === "static") {
      img.src = apiUrl(slide.url);
    } else if (chartUrls[slide.key]) {
      img.src = chartUrls[slide.key];
    } else {
      loadChart(slide.key, function (url) {
        /* a slow fetch must not overwrite a slide the user has since
           navigated to — same stale-response guard as refreshAll */
        var cur = SLIDES[slideIndex];
        if (cur.kind === "chart" && cur.key === slide.key) {
          img.src = url;
        }
      });
    }
    label.textContent = slide.label;
    markDot(slideIndex);
  }

  function nextSlide() { showSlide(slideIndex + 1); }
  function prevSlide() { showSlide(slideIndex - 1); }

  function startSlideshow() {
    if (slideshowTimer) clearInterval(slideshowTimer);
    slideshowTimer = setInterval(function () {
      if (!paused) nextSlide();
    }, slideshowInterval);
  }

  /* periodic refresh of charts + missing days (ref :52-99) */
  function refreshAll() {
    CHART_TYPES.forEach(function (t) {
      loadChart(t, function (url) {
        var cur = SLIDES[slideIndex];
        if (cur.kind === "chart" && cur.key === t) {
          document.getElementById("slide-img").src = url;
        }
      });
    });
    loadChart("zeiger", function (url) {
      document.getElementById("gauge-img").src = url;
    });
    fetch(apiUrl("/api/dynamischer_inhalt"), { cache: "no-store" })
      .then(function (r) { return r.json(); })
      .then(function (data) {
        var ul = document.getElementById("missing-days");
        ul.innerHTML = "";
        if (!data.missing_days || data.missing_days.length === 0) {
          ul.innerHTML = "<li>keine 😊</li>";
        } else {
          data.missing_days.forEach(function (d) {
            var li = document.createElement("li");
            li.textContent = d;
            ul.appendChild(li);
          });
        }
      })
      .catch(function (e) { console.error("missing days:", e); });
  }

  /* 1 Hz clock (ref :203-222) */
  function tickClock() {
    var el = document.getElementById("clock");
    if (el) el.textContent = new Date().toLocaleString("de-DE");
  }

  document.addEventListener("DOMContentLoaded", function () {
    document.getElementById("next-btn").addEventListener("click", nextSlide);
    document.getElementById("prev-btn").addEventListener("click", prevSlide);
    document.getElementById("pause-btn").addEventListener("click", function () {
      paused = !paused;
      this.textContent = paused ? "▶" : "⏸";
    });
    buildDots();

    fetch(apiUrl("/config/slideshow_interval"))
      .then(function (r) { return r.json(); })
      .then(function (data) {
        var v = parseInt(data.slideshow_interval, 10);
        if (v > 0) slideshowInterval = v;
        startSlideshow();
      })
      .catch(function () { startSlideshow(); });

    refreshAll();
    showSlide(0);
    setInterval(refreshAll, RELOAD_INTERVAL);
    setInterval(tickClock, 1000);
    tickClock();
  });
})();
